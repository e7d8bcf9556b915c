"""Trace replay — fold a recorded trace back into profiling inputs.

The paper's tool is *profile-guided* partitioning (§III-E): measure a real
execution, then let the DSE pick the hardware/software split.  A recorded
trace is a complete measurement, so this module turns one into

  * ``phase_totals``       — the per-lane stage/dispatch/sync/retire split
    (what ``benchmarks/roofline.boundary_breakdown`` renders), and
  * ``snapshot_from_trace`` — a ``TelemetrySnapshot``, the exact structure
    the live serving engine accumulates; ``core.profiler.profile_from_trace``
    feeds it through ``profile_from_telemetry``, so the offline-from-trace
    and live-telemetry DSE paths share one ingestion code path.

Event conventions consumed here (produced by the runtime instrumentation —
see docs/observability.md for the full schema):

  cat ``actor``    X-span per actor-machine invoke; ``args.fires``.
  cat ``plink``    X-span per launch phase, name in stage/dispatch/sync/
                   retire, on a ``lane:*`` track; ``args.tokens``/``k``.
  cat ``device``   serve-mode batched lanes: ``dispatch`` events carry
                   ``args.lanes``/``tokens_in``; ``retire`` spans carry
                   ``args.tokens_out``/``time_ns`` — the *same numbers* the
                   batcher feeds live telemetry, so replay is exact.
  cat ``channel``  C-counters named ``src.sp->dst.dp`` whose args carry the
                   authored endpoints and whose value is a token delta.
  cat ``session``  lifecycle instants (open/close/submit) on session tracks.
  cat ``engine``   hot-swap instants.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from repro_torch.observability.chrome import chrome_trace, load_trace
from repro_torch.observability.recorder import TraceRecorder

PHASES = ("stage", "dispatch", "sync", "retire")

ChannelKey = Tuple[str, str, str, str]


def authored_channel_key(module, ch_key: ChannelKey) -> ChannelKey:
    """Map a lowered channel key back to its authored-graph key.

    Fusion renames boundary endpoints to ``fusedN`` / ``member__PORT``; the
    MILP evaluates over authored channels, so recorded token totals must
    carry the authored key.  Ports of fused actors encode their member as
    ``member__PORT``."""
    src, sp, dst, dp = ch_key
    g = getattr(module, "source", None)
    if g is None:
        return ch_key
    if src not in g.actors and "__" in sp:
        src, sp = sp.split("__", 1)
    if dst not in g.actors and "__" in dp:
        dst, dp = dp.split("__", 1)
    return (src, sp, dst, dp)


def _events(src: Union[Dict, TraceRecorder, str]) -> List[Dict]:
    """Normalize any trace carrier to the Chrome event list."""
    if isinstance(src, TraceRecorder):
        src = chrome_trace(src)
    return load_trace(src).get("traceEvents", [])


def phase_totals(
    trace: Union[Dict, TraceRecorder, str]
) -> Dict[str, Dict[str, float]]:
    """Per-lane boundary-phase wall time from a trace.

    Returns ``{lane track: {stage_ns, dispatch_ns, sync_ns, retire_ns,
    launches}}`` — the split ``PLinkStats`` accumulates live, rebuilt from
    the span layer (the single source of truth), so benchmark renderers
    need no duplicated accumulation logic.
    """
    tracks: Dict[int, str] = {}
    out: Dict[str, Dict[str, float]] = {}
    for ev in _events(trace):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tracks[ev["tid"]] = ev["args"]["name"]
            continue
        if ev.get("cat") != "plink" or ev.get("ph") != "X":
            continue
        if ev["name"] not in PHASES:
            continue
        lane = tracks.get(ev.get("tid"), f"tid:{ev.get('tid')}")
        d = out.setdefault(
            lane, {f"{p}_ns": 0.0 for p in PHASES} | {"launches": 0}
        )
        d[f"{ev['name']}_ns"] += ev.get("dur", 0.0) * 1e3  # µs -> ns
        if ev["name"] == "dispatch":
            d["launches"] += 1
    return out


def snapshot_from_trace(
    trace: Union[Dict, TraceRecorder, str],
    *,
    seconds: Optional[float] = None,
):
    """Rebuild a ``TelemetrySnapshot`` from a recorded trace.

    The snapshot aggregates exactly what the live ``ServerTelemetry``
    would have seen over the same run: per-actor firing counts and wall
    time from ``actor`` spans, per-link token totals from ``channel``
    counters, and device dispatch/lane/latency figures from ``device``
    events (serve-mode batches) or ``plink`` phase spans (scheduler runs).
    """
    from repro_torch.serve_stream.telemetry import TelemetrySnapshot

    actor_fires: Dict[str, int] = {}
    actor_time: Dict[str, int] = {}
    channel_tokens: Dict[ChannelKey, int] = {}
    dispatches = lanes = width = lanes_peak = 0
    device_time_ns = 0
    tok_in = tok_out = 0
    opened = closed = chunks = split = submitted = delivered = swaps = 0
    queue_peak = 0
    t_lo: Optional[float] = None
    t_hi = 0.0

    for ev in _events(trace):
        ph, cat = ev.get("ph"), ev.get("cat")
        if ph == "M":
            continue
        ts = ev.get("ts", 0.0)
        if t_lo is None or ts < t_lo:
            t_lo = ts
        t_hi = max(t_hi, ts + ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat == "actor" and ph == "X":
            name = ev["name"]
            actor_fires[name] = actor_fires.get(name, 0) + int(
                args.get("fires", 0)
            )
            actor_time[name] = actor_time.get(name, 0) + round(
                ev.get("dur", 0.0) * 1e3
            )
        elif cat == "channel" and ph == "C":
            key = (
                args.get("src"), args.get("src_port"),
                args.get("dst"), args.get("dst_port"),
            )
            if all(k is not None for k in key):
                channel_tokens[key] = (
                    channel_tokens.get(key, 0) + int(args["value"])
                )
        elif cat == "device":
            if ev["name"] == "dispatch":
                dispatches += 1
                ln = int(args.get("lanes", 1))
                lanes += ln
                lanes_peak = max(lanes_peak, ln)
                width += int(args.get("width", 0)) or ln
                tok_in += int(args.get("tokens_in", 0))
                device_time_ns += int(args.get("time_ns", 0))
            elif ev["name"] == "retire":
                tok_out += int(args.get("tokens_out", 0))
                device_time_ns += int(args.get("time_ns", 0))
        elif cat == "plink" and ph == "X":
            # scheduler-run lanes: one dispatch per launch; the host-observed
            # device time is the dispatch + readiness-poll + retire wall time
            if ev["name"] == "dispatch":
                dispatches += 1
                lanes += 1
                width += 1
                lanes_peak = max(lanes_peak, 1)
                tok_in += int(args.get("tokens", 0))
            if ev["name"] in ("dispatch", "sync", "retire"):
                device_time_ns += round(ev.get("dur", 0.0) * 1e3)
            if ev["name"] == "retire":
                tok_out += int(args.get("tokens", 0))
        elif cat == "session":
            if ev["name"] == "session_open":
                opened += 1
            elif ev["name"] == "session_close":
                closed += 1
            elif ev["name"] == "submit":
                chunks += int(args.get("chunks", 1))
                split += int(args.get("split", 0))
                submitted += int(args.get("tokens", 0))
                queue_peak = max(queue_peak, int(args.get("queued", 0)))
            elif ev["name"] == "deliver":
                delivered += int(args.get("tokens", 0))
        elif cat == "engine" and ev["name"] == "hot_swap":
            swaps += 1

    if seconds is None:
        seconds = 0.0 if t_lo is None else max(t_hi - t_lo, 0.0) / 1e6
    return TelemetrySnapshot(
        seconds=seconds,
        actor_fires=actor_fires,
        actor_time_ns=actor_time,
        channel_tokens=channel_tokens,
        device_dispatches=dispatches,
        device_lanes=lanes,
        device_width=width,
        lanes_peak=lanes_peak,
        device_time_ns=device_time_ns,
        device_tokens_in=tok_in,
        device_tokens_out=tok_out,
        sessions_opened=opened,
        sessions_closed=closed,
        chunks_submitted=chunks,
        chunks_split=split,
        tokens_submitted=submitted,
        tokens_delivered=delivered,
        queue_peak=queue_peak,
        swaps=swaps,
    )
