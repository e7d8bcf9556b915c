"""Continuous batched device dispatch — a rolling batch, one launch per round.

The sequential path costs one step call (and one stream-kernel launch
inside each fused region) *per session per block*.  The batcher packs the
staged blocks of many sessions into a single batched ``DeviceProgram``
call (``batched_step``): each session's lane is bit-identical to its own
sequential dispatch, and on a program whose members are all fused CUDA
stream regions each region's kernel launches once for the whole round.

Unlike the original drain-per-block batcher (power-of-two buckets, each
session riding at most one in-flight batch), dispatch is *continuous*:

  * **rolling rounds** — sessions join and leave the batch at block
    boundaries without draining the in-flight set.  A session's device
    state is never round-tripped to host between rounds: each launch
    immediately rebinds ``stage.state`` to that lane's slice of the
    launch's output state tensors, so the same session can ride the very
    next round while the previous one is still computing — the CUDA stream
    orders the launches.  Retire only moves *outputs* back to host FIFOs,
    oldest round first, preserving per-session order: a round's outputs
    are copied into pinned host memory behind its launch, and a
    ``torch.cuda.Event`` recorded after those copies says when it is ready
    (a CPU program's round is ready at once).
  * **ragged lane packing** — a round's batch width is the live lane
    count, not a power-of-two bucket.  When reusing an already-compiled
    width saves a retrace (within ``LANE_SLACK`` waste), the round is
    padded with *masked* lanes — init state, all-False masks, outputs
    discarded — instead of duplicating the last real lane's state and
    payload.  The port has no trace cache to bound, but keeps the
    reference's widths so lane layouts match it.
  * **fairness** — the engine hands ``launch`` a fairness-ordered stage
    list (``serve_stream.admission.DeficitRoundRobin``); everything past
    ``max_batch`` waits for the next round and the rotation guarantees it
    gets one.
  * **sequential mode** — ``mode="sequential"`` dispatches one launch per
    session instead; it exists as the benchmark baseline
    (``benchmarks/server_throughput.py``) and a debugging aid.  State
    chaining works the same way, so even sequential sessions ride
    back-to-back launches.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.runtime.plink import _np
from repro_torch.serve_stream.session import DeviceStage

# A round may be padded with masked lanes up to this factor over the live
# lane count when that reuses an already-compiled width — bounds wasted
# lanes at ~1/3 (the power-of-two buckets it replaces wasted up to 2x,
# *and* computed a duplicated real lane instead of a masked no-op).
LANE_SLACK = 4 / 3


def _to_host(program, outs) -> Tuple[Dict, object]:
    """One launch's outputs as host tensors, and the readiness event: on
    CUDA, asynchronous copies into pinned memory and an event recorded
    after them; on the CPU the outputs themselves and no event."""
    if program.device.type != "cuda":
        return outs, None
    host = {}
    for key, (v, m) in outs.items():
        hv = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        hm = torch.empty(m.shape, dtype=m.dtype, pin_memory=True)
        hv.copy_(v, non_blocking=True)
        hm.copy_(m, non_blocking=True)
        host[key] = (hv, hm)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(program.device))
    return host, event


def _on(device):
    """The device context a launch and its copies are enqueued under."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclass
class _Round:
    """One in-flight launch: ``riders`` are the real lanes (lane index ==
    list position); padded mask-only lanes are never retired."""

    riders: List[DeviceStage]
    outs: Dict                         # {port: (vals, mask)} host tensors
    width: int                         # launch width (>= len(riders))
    batched: bool
    t_launch_ns: int = 0
    event: object = None               # torch.cuda.Event after the D2H copies


class DeviceBatcher:
    """Owns every in-flight device dispatch of one ``StreamServer``."""

    def __init__(
        self,
        program,
        *,
        mode: str = "continuous",   # "continuous" | "sequential"
        max_batch: int = 32,
        depth: int = 2,             # in-flight rounds (double buffering)
        telemetry=None,
        recorder=None,
        chaos=None,
    ):
        if mode == "batched":       # legacy alias for the rolling batcher
            mode = "continuous"
        if mode not in ("continuous", "sequential"):
            raise ValueError(f"DeviceBatcher mode {mode!r}")
        self.program = program
        self.mode = mode
        self.max_batch = max(1, max_batch)
        self.depth = max(1, depth)
        self.telemetry = telemetry
        self.recorder = recorder  # streamtrace (None = untraced server)
        self.chaos = chaos        # fault injection (None = no chaos)
        self._track = "batch:" + (
            getattr(program, "partition", "") or program.name
        )
        self.inflight: List[_Round] = []
        self._widths: set = set()  # batch widths already launched
        self._pad_payload = None   # zero (vals, mask) arrays, built lazily

    # -- width selection ------------------------------------------------------
    def _width(self, live: int) -> int:
        """Smallest already-compiled width within ``LANE_SLACK`` of the live
        lane count, else exactly the live count (and remember it)."""
        cap = min(math.ceil(live * LANE_SLACK), self.max_batch)
        reuse = [w for w in self._widths if live <= w <= cap]
        w = min(reuse) if reuse else live
        self._widths.add(w)
        return w

    def _pad(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """The masked no-op payload one pad lane contributes: zeros with an
        all-False mask, so the batched step treats the lane as dead work."""
        if self._pad_payload is None:
            from repro_torch.serve_stream.session import _np_dtype

            k = max(1, getattr(self.program, "megastep_k", 1))
            shape = (
                (k, self.program.block) if k > 1 else (self.program.block,)
            )
            self._pad_payload = {
                f"{a}.{p}": (
                    np.zeros(shape, _np_dtype(dt)),
                    np.zeros(shape, bool),
                )
                for (a, p, dt) in self.program.in_ports
            }
        return self._pad_payload

    def _traced_dispatch(self, lanes: int, tokens_in: int, width: int) -> None:
        """Mirror one ``device_dispatched`` telemetry record into the trace
        (same lanes/token counts, so replay is exact)."""
        if self.telemetry is not None:
            self.telemetry.device_dispatched(lanes, tokens_in, width=width)
        if self.recorder is not None:
            self.recorder.instant(
                self._track, "dispatch", "device",
                {"lanes": lanes, "tokens_in": tokens_in, "width": width},
            )

    # -- launch --------------------------------------------------------------
    def can_launch(self) -> bool:
        return len(self.inflight) < self.depth

    def launch(self, stages: List[DeviceStage]) -> int:
        """Dispatch one round over up to ``max_batch`` of ``stages`` (in the
        given order — the engine's fairness ordering); returns lanes
        launched.  Stages already riding an earlier round may join: their
        state is the previous round's output and the stream orders the
        launches."""
        if self.chaos is not None:
            # chaos site BEFORE any staging: an injected launch failure
            # leaves every FIFO and stage untouched, so the engine's
            # bounded retry replays the identical round with zero token
            # loss (docs/reliability.md)
            self.chaos.poke(
                "launch:"
                + (getattr(self.program, "partition", "")
                   or self.program.name)
            )
        payloads = []
        live: List[DeviceStage] = []
        for st in stages:
            if len(live) >= self.max_batch:
                break
            staged = st.stage()
            if staged is not None:
                payloads.append(staged)
                live.append(st)
        if not live:
            return 0
        t0 = time.perf_counter_ns()
        with _on(self.program.device):
            self._dispatch(live, payloads)
        dt = time.perf_counter_ns() - t0
        new = self.inflight[-1:] if self.mode != "sequential" else (
            self.inflight[-len(live):]
        )
        for entry in new:  # split the call's wall time across its dispatches
            entry.t_launch_ns = dt // len(new)
        return len(live)

    def _dispatch(self, live: List[DeviceStage], payloads: List[Dict]) -> None:
        if self.mode == "sequential":
            # one dispatch per session — the per-session baseline.  launch()
            # routes to the megastep when the program runs k>1 iterations
            # per dispatch (payloads are (k, block) chunk stacks).
            for st, staged in zip(live, payloads):
                tokens = sum(int(m.sum()) for _, m in staged.values())
                ins = {
                    k: (v[0], m[0])
                    for k, (v, m) in self.program.pack_lanes([staged]).items()
                }
                state, outs, _idle = self.program.launch(st.state, ins)
                st.state = state  # the chain: next launch feeds here
                st.inflight += 1
                host, event = _to_host(self.program, outs)
                self.inflight.append(
                    _Round([st], host, width=1, batched=False, event=event)
                )
                self._traced_dispatch(1, tokens, width=1)
        else:
            tokens = sum(
                int(m.sum()) for p in payloads for _, m in p.values()
            )
            width = self._width(len(live))
            padded = payloads + [self._pad()] * (width - len(live))
            states = [st.state for st in live]
            states += [self.program.init_state] * (width - len(live))
            state_b = self.program.stack_states(states)
            ins_b = self.program.pack_lanes(padded)
            batched_fn = (
                self.program.batched_megastep(width)
                if getattr(self.program, "megastep_k", 1) > 1
                else self.program.batched_step(width)
            )
            state_b, outs, _idle = batched_fn(state_b, ins_b)
            for lane, st in enumerate(live):
                # rebind each rider to its lane's output state so it can
                # ride the NEXT round before this one retires
                st.state = self.program.unstack_state(state_b, lane)
                st.inflight += 1
            host, event = _to_host(self.program, outs)
            self.inflight.append(
                _Round(live, host, width=width, batched=True, event=event)
            )
            self._traced_dispatch(len(live), tokens, width=width)

    # -- retire --------------------------------------------------------------
    def poll(self, block: bool = False) -> int:
        """Retire completed rounds (oldest first, preserving per-session
        order); ``block=True`` forces the oldest to completion.  Returns
        tokens moved back into host FIFOs."""
        moved = 0
        while self.inflight:
            head = self.inflight[0]
            if not block and head.event is not None and not head.event.query():
                break
            if head.event is not None:
                head.event.synchronize()
            moved += self._retire(head)
            self.inflight.pop(0)
            block = False  # only force the oldest
        return moved

    def _retire(self, entry: _Round) -> int:
        t0 = time.perf_counter_ns()
        moved = 0
        outs_np = {k: (_np(v), _np(m)) for k, (v, m) in entry.outs.items()}
        if entry.batched:
            for lane, st in enumerate(entry.riders):
                lane_outs = {
                    k: (v[lane], m[lane]) for k, (v, m) in outs_np.items()
                }
                moved += st.retire(lane_outs)
        else:
            (st,) = entry.riders
            moved += st.retire(outs_np)
        dt = time.perf_counter_ns() - t0
        if self.telemetry is not None:
            self.telemetry.device_retired(moved, dt + entry.t_launch_ns)
        if self.recorder is not None:
            # args.time_ns carries the telemetry value (retire + its share
            # of the launch call) so replay matches device_time_ns exactly;
            # the span itself shows the host-side retire work
            self.recorder.complete(
                self._track, "retire", "device", t0, dt,
                {
                    "tokens_out": moved,
                    "lanes": len(entry.riders),
                    "time_ns": dt + entry.t_launch_ns,
                },
            )
        return moved

    # -- introspection -------------------------------------------------------
    @property
    def pending(self) -> bool:
        return bool(self.inflight)

    def drain(self) -> int:
        """Force-retire everything in flight (poll only forces the oldest)."""
        moved = 0
        while self.inflight:
            moved += self.poll(block=True)
        return moved
