"""Profiling (paper §III-E + §VII-C): the MILP's four inputs.

  (i)   per-actor device times   — measured by running the compiled device
        partition (stands in for cycle-accurate SystemC co-simulation),
  (ii)  per-actor software times — perf_counter_ns around firings (rdtscp analogue),
  (iii) software FIFO bandwidth  — pass-through round-trip microbenchmark,
  (iv)  host<->device transfer times over buffer sizes — device_put/get timings
        (OpenCL event-counter analogue).

``fit_link_model`` least-squares fits ξ(b) = latency + bytes/bandwidth.

Port of ``repro/core/profiler.py``.  ``profile_device`` compiles each
device-eligible actor as a single-actor partition on a torch device (default
``cuda:0``) and waits with ``torch.cuda.synchronize`` where the reference
calls ``jax.block_until_ready`` (nothing to wait for on the CPU); on the
card every partition's step is timed as one CUDA-graph replay
(``capture_step``), the counterpart of the reference's jitted dispatch,
where eager per-op launches would price launch overhead (ROADMAP C8).
Only the profiler replays graphs: a run launches its partitions eagerly.
``measure_device_link`` times pinned host tensors copied to the card with
``non_blocking=True`` and a synchronisation, as PLink stages, and raises
without CUDA.  The other functions are copies.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple


import numpy as np
import torch

from repro_torch.core.cost_model import LinkModel, NetworkProfile
from repro_torch.core.graph import ActorGraph, GraphError
from repro_torch.pytree import tree_leaves
from repro_torch.runtime.scheduler import HostRuntime


def profile_host(
    graph: ActorGraph,
    *,
    controller: str = "am",
    max_rounds: int = 1_000_000,
    max_seconds: Optional[float] = None,
) -> Tuple[NetworkProfile, HostRuntime]:
    """Run single-threaded, collect exec_sw + channel token counts.

    ``max_seconds`` is a wall-clock budget: a network that never quiesces
    (server-style pipelines, unbounded sources) yields the profile gathered
    so far instead of hanging for ``max_rounds`` rounds.
    """
    rt = HostRuntime(graph, None, controller=controller)
    rt.run_single(max_rounds, max_seconds=max_seconds, on_deadline="return")
    prof = NetworkProfile()
    for name, p in rt.profiles.items():
        prof.exec_sw[name] = p.time_ns / 1e9
    for ch in graph.channels:
        f = rt.fifos[str(ch)]
        prof.tokens[ch.key] = f.total_written
        prof.buffers[ch.key] = f.capacity
    return prof, rt


def profile_host_fused(
    graph: ActorGraph,
    prof: NetworkProfile,
    *,
    controller: str = "am",
    block: int = 1024,
    max_rounds: int = 1_000_000,
    max_seconds: Optional[float] = None,
) -> NetworkProfile:
    """Measure ``exec_sw_fused``: per-actor host time under fused block
    execution (the ``fuse-sdf-host-regions`` executor).

    Runs the host-only placement once with host fusion enabled and splits
    each fused region's wall time over its members in proportion to their
    interpreted times (one block invocation cannot be attributed per
    member — the same convention ``profile_from_telemetry`` uses for batched
    device launches).  Actors outside any fused region keep no fused
    coefficient: the evaluator then correctly charges them the interpreted
    rate.  These coefficients are what lets ``explore()`` price host design
    points at the fused runtime's actual speed instead of the interpreter's.
    """
    from repro_torch.ir.passes import lower

    module = lower(graph, None, block=block)
    specs = module.meta.get("host_fused") or {}
    if not specs:
        return prof
    rt = HostRuntime(module, controller=controller)
    rt.run_single(max_rounds, max_seconds=max_seconds, on_deadline="return")
    for gid, spec in specs.items():
        p = rt.profiles.get(gid)
        if p is None or not p.time_ns:
            continue
        weights = {m: max(prof.exec_sw.get(m, 0.0), 0.0) for m in spec.members}
        total_w = sum(weights.values())
        for m in spec.members:
            share = (
                weights[m] / total_w if total_w > 0
                else 1.0 / len(spec.members)
            )
            prof.exec_sw_fused[m] = p.time_ns / 1e9 * share
    return prof


CAPTURE_WARMUP = 3  # eager calls on a side stream before a capture


def capture_step(step, state, inputs, device):
    """``step(state, inputs)`` captured once as a CUDA graph on ``device``
    after ``CAPTURE_WARMUP`` eager calls on a side stream: ``(graph, out)``.
    ``graph.replay()`` reruns the step's kernels on the tensors it was
    captured with, where they lie, and rewrites ``out`` in place, bit for
    bit the eager step's.  The caller keeps ``state`` and ``inputs`` alive
    while it replays.  A tensor off ``device`` is refused, and a step that
    cannot be captured raises."""
    device = torch.device(device)
    off = {
        t.device for t in tree_leaves((state, inputs))
        if isinstance(t, torch.Tensor) and t.device != device
    }
    if device.type != "cuda" or off:
        raise ValueError(
            f"capture_step: the arguments must lie on one CUDA device "
            f"({device}; found {sorted(map(str, off))})"
        )
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                step(state, inputs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step(state, inputs)
    return graph, out


def profile_device(
    graph: ActorGraph,
    prof: NetworkProfile,
    *,
    block: int = 4096,
    repeats: int = 5,
    max_seconds: Optional[float] = None,
    device=None,
) -> NetworkProfile:
    """Measure exec_hw per device-placeable actor by running it (plus required
    context) as a compiled single-actor partition over its observed workload.

    ``max_seconds`` bounds the whole sweep: actors not reached before the
    budget expires simply keep no ``exec_hw`` entry (the MILP then treats
    them as host-only), which beats hanging a live server's repartition
    loop on a slow compile.  ``device`` is the torch device the partitions
    run on (default ``cuda:0``); on the card each step is timed as one
    CUDA-graph replay (``capture_step``), and a step that cannot be
    captured raises."""
    from repro_torch.runtime.device_runtime import compile_partition

    device = torch.device("cuda:0" if device is None else device)

    deadline = (
        None if max_seconds is None else time.perf_counter() + max_seconds
    )
    for name, actor in graph.actors.items():
        if deadline is not None and time.perf_counter() >= deadline:
            break
        if not actor.device_ok:
            continue
        try:
            program = compile_partition(graph, [name], block=block, device=device)
        except (AssertionError, GraphError):
            # not device-compilable (host-only, or legalization rejects the
            # channel dtypes) — no hw time for this actor
            continue
        dev = program.device
        ins = {
            f"{a}.{p}": (
                torch.zeros((block,), dtype=torch.float32, device=dev),
                torch.ones((block,), dtype=torch.bool, device=dev),
            )
            for (a, p, _dt) in program.in_ports
        }

        def wait(_dev=dev):
            if _dev.type == "cuda":
                torch.cuda.synchronize(_dev)

        state = program.init_state
        # total tokens this actor processes over the workload
        in_keys = [
            k for k in prof.tokens
            if k[2] == name
        ]
        total = max(
            [prof.tokens[k] for k in in_keys]
            or [max(prof.tokens.values(), default=block)]
        )
        # warmup + two-point fit: time(n) = launch_overhead + n·rate, so the
        # per-launch XLA dispatch cost is separated from the streaming rate
        # (single-point measurement overstates hw time for small blocks).
        half = {
            k: (v[0][: block // 2], v[1][: block // 2]) for k, v in ins.items()
        }
        if dev.type == "cuda":
            # one replay of the step's kernels, the counterpart of the
            # reference's jitted dispatch (ROADMAP C8)
            calls = [
                capture_step(program.step, state, p, dev)[0].replay
                for p in (ins, half)
            ]
        else:
            calls = [lambda p=p: program.step(state, p) for p in (ins, half)]
        for call in calls:
            call()
            wait()

        def timed(call):
            t0 = time.perf_counter_ns()
            for _ in range(repeats):
                call()
            wait()
            return (time.perf_counter_ns() - t0) / repeats / 1e9

        t_full, t_half = (timed(call) for call in calls)
        rate = max((t_full - t_half) / (block - block // 2), 0.0)
        overhead = max(t_full - rate * block, 0.0)
        n_launch = max(1, -(-total // block))
        prof.exec_hw[name] = overhead * n_launch + rate * total
    return prof


def fit_link_model(
    name: str, sizes_bytes: Sequence[int], times_s: Sequence[float],
    token_bytes: int = 4,
) -> LinkModel:
    A = np.stack([np.ones(len(sizes_bytes)), np.asarray(sizes_bytes, float)], 1)
    sol, *_ = np.linalg.lstsq(A, np.asarray(times_s, float), rcond=None)
    lat = max(float(sol[0]), 1e-9)
    inv_bw = max(float(sol[1]), 1e-15)
    return LinkModel(name, lat, 1.0 / inv_bw, token_bytes)


def measure_fifo_bandwidth(
    *, cross_thread: bool, sizes: Sequence[int] = (64, 256, 1024, 4096, 16384),
    token_bytes: int = 4,
) -> Tuple[LinkModel, List[Tuple[int, float]]]:
    """Paper §VII-C: round-trip through a pass-through actor, /2 per direction."""
    from repro_torch.core.actor import simple_actor, sink_actor, source_actor
    from repro_torch.core.graph import ActorGraph as AG

    points = []
    for n in sizes:
        g = AG("bw")
        data = iter(range(n))

        def gen(st):
            x = st.get("i", 0)
            if x >= n:
                return st, None
            return {"i": x + 1}, float(x)

        g.add(source_actor("src", gen))
        g.add(simple_actor("pass", lambda st, v: (st, v)))
        g.add(sink_actor("snk", lambda st, v: st))
        g.connect("src", "pass", depth=max(64, n))
        g.connect("pass", "snk", depth=max(64, n))
        mapping = (
            {"src": "a", "pass": "b", "snk": "a"}
            if cross_thread
            else {"src": "a", "pass": "a", "snk": "a"}
        )
        rt = HostRuntime(g, mapping)
        t0 = time.perf_counter()
        if cross_thread:
            rt.run_threads()
        else:
            rt.run_single()
        dt = (time.perf_counter() - t0) / 2  # round trip -> one direction
        points.append((n * token_bytes, dt))
    model = fit_link_model(
        "inter-core" if cross_thread else "intra-core",
        [p[0] for p in points], [p[1] for p in points], token_bytes,
    )
    return model, points


def profile_from_telemetry(
    graph: ActorGraph,
    snap,  # repro_torch.serve_stream.telemetry.TelemetrySnapshot (duck-typed)
    base: Optional[NetworkProfile] = None,
) -> NetworkProfile:
    """Turn a live server telemetry window into MILP inputs (§III-E, online).

    The offline profiler measures a *calibration* run once; a serving engine
    sees the real traffic, so its window is the better estimate wherever it
    has one:

      * ``exec_sw``   — live per-actor firing time for actors that ran on
        host threads this window; actors currently on the device keep the
        ``base`` profile's software time (they produced no host sample);
      * ``exec_sw_fused`` — live: a fused host region reports under one
        ``hostfused:a+b+c`` key (one block invocation cannot be attributed
        per member), split over the members in proportion to their ``base``
        software times — the MILP's distinct host-fused coefficients;
      * ``exec_hw``   — live: the window's device wall time shared across
        the device actors in proportion to their ``base`` hw times (one
        batched launch cannot be attributed per actor), falling back to an
        even split, for actors that rode a dispatch; others keep ``base``;
      * ``tokens``    — live per-link totals, merged over ``base``'s so
        links currently fused away keep their calibration counts;
      * link models / buffers / core counts — carried from ``base``.

    The result is what ``partitioner.explore`` re-solves against in the
    online repartition loop.
    """
    prof = NetworkProfile()
    if base is not None:
        prof.exec_sw.update(base.exec_sw)
        prof.exec_sw_fused.update(base.exec_sw_fused)
        prof.exec_hw.update(base.exec_hw)
        prof.tokens.update(base.tokens)
        prof.buffers.update(base.buffers)
        prof.links.update(base.links)
        prof.in_situ = base.in_situ
        prof.n_cores = base.n_cores
    fused_members: set = set()
    for actor, t_ns in snap.actor_time_ns.items():
        if actor in graph.actors:
            prof.exec_sw[actor] = t_ns / 1e9
        elif actor.startswith("hostfused:"):
            members = [
                m for m in actor.split(":", 1)[1].split("+")
                if m in graph.actors
            ]
            if not members:
                continue
            fused_members.update(members)
            weights = {
                m: (base.exec_sw.get(m, 0.0) if base is not None else 0.0)
                for m in members
            }
            total_w = sum(weights.values())
            for m in members:
                share = (
                    weights[m] / total_w if total_w > 0
                    else 1.0 / len(members)
                )
                prof.exec_sw_fused[m] = t_ns / 1e9 * share
    for key, n in snap.channel_tokens.items():
        prof.tokens[key] = max(prof.tokens.get(key, 0), n)
    device_s = snap.device_time_ns / 1e9
    if device_s > 0:
        # host-fused members produced no per-actor host sample either, but
        # they ran on a host thread this window — never device-attribute them
        hw_actors = [
            a for a, act in graph.actors.items()
            if act.device_ok
            and a not in snap.actor_time_ns
            and a not in fused_members
        ]
        if hw_actors:
            weights = {
                a: (base.exec_hw.get(a, 0.0) if base is not None else 0.0)
                for a in hw_actors
            }
            total_w = sum(weights.values())
            for a in hw_actors:
                share = (
                    weights[a] / total_w if total_w > 0
                    else 1.0 / len(hw_actors)
                )
                prof.exec_hw[a] = device_s * share
    if prof.n_cores is None:
        import os

        prof.n_cores = os.cpu_count()
    return prof


def profile_from_trace(
    graph: ActorGraph,
    trace,  # TraceRecorder | Chrome-trace payload dict | path to one
    base: Optional[NetworkProfile] = None,
    *,
    seconds: Optional[float] = None,
) -> NetworkProfile:
    """Turn a recorded streamtrace into MILP inputs (§III-E, offline).

    A trace file is a complete measurement of a real run, so the DSE can
    replay it long after the run: the trace folds into a
    ``TelemetrySnapshot`` (``observability.snapshot_from_trace``) and goes
    through the SAME ``profile_from_telemetry`` ingestion the live serving
    engine uses — one code path, two sources.  Instrumentation records the
    identical durations/counts it feeds live telemetry, so the trace-fed
    and telemetry-fed profiles (and the placements ``explore`` picks from
    them) agree.
    """
    from repro_torch.observability.trace_profile import snapshot_from_trace

    snap = snapshot_from_trace(trace, seconds=seconds)
    return profile_from_telemetry(graph, snap, base)


def measure_device_link(
    sizes: Sequence[int] = (2**12, 2**16, 2**20, 2**22), repeats: int = 10,
    device=None,
) -> Tuple[LinkModel, List[Tuple[int, float]]]:
    """Host->device transfer timing (the OpenCL write-bandwidth analogue):
    a pinned host tensor of each size copied to the card with
    ``non_blocking=True`` and waited for, as PLink stages.  Needs CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "measure_device_link: CUDA is not available; the link it "
            "measures is the host-to-card copy"
        )
    dev = torch.device("cuda:0" if device is None else device)
    points = []
    for n in sizes:
        arr = torch.zeros((n // 4,), dtype=torch.float32, pin_memory=True)
        arr.to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            arr.to(dev, non_blocking=True)
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / repeats
        points.append((n, dt))
    model = fit_link_model(
        "pcie", [p[0] for p in points], [p[1] for p in points]
    )
    return model, points
