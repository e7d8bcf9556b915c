"""PLink — the partition-link actor (paper §III-D), over torch devices.

Bridges the host software partition and a compiled device partition: it
(1) drains host FIFOs into a staging ring of host tensors (pinned on CUDA)
and copies them to the device asynchronously (the input-stage burst),
(2) launches the device step, which enqueues its kernels on the current
CUDA stream and returns at once,
(3) copies the boundary outputs, their masks and the idle flag back into
pinned host buffers asynchronously, records a ``torch.cuda.Event`` after
those copies, and writes the results into host FIFOs once the event has
completed, and
(4) reads the device idleness flag instead of polling internal state.

PLink is itself an actor on a host thread and never blocks it: if the
in-flight launch's event has not completed, PLink simply yields so other
actors on its thread keep working — the paper's non-blocking OpenCL event
design.

Staging ring: ``_N_SLOTS`` slots of ``(k, block)`` host buffers per boundary
port, and up to ``_MAX_INFLIGHT`` launches in flight while the next block is
packed.  A slot stays busy until its launch's event completes, so a pinned
buffer is never rewritten while an async H2D copy may still read it, nor an
output buffer while the D2H copy may still write it.  Device state never
round-trips: each launch takes the previous launch's state tensors (``self
.state`` is updated at dispatch time, not at retirement), and retirement
reads only the host copies of the boundary outputs and the idle flag.  On a
CPU device the step runs synchronously and the outputs are read directly.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Tuple

import numpy as np
import torch

from repro_torch.observability.recorder import current as _trace_current
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime.device_runtime import NARROW_64, DeviceProgram
from repro_torch.runtime.fifo import ArrayFifo

_warned_dtypes = set()  # warn once per dtype per process


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned_dtypes:
        _warned_dtypes.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _host_dtype(dt: str) -> torch.dtype:
    """Torch dtype of a port's staging buffer at the host/device boundary.

    bfloat16 stages as ``torch.bfloat16`` (2 bytes a token).  Numeric
    dtypes resolve through numpy, 64-bit ones narrowed to 32 bits
    (``NARROW_64``).  Anything
    the boundary cannot stage (e.g. ``object``) is rejected at compile time
    by the placement-legalization pass — reaching here with one means a
    hand-built program bypassed the pipeline, so we warn explicitly instead
    of silently miscasting.
    """
    if dt == "bfloat16":
        return torch.bfloat16
    try:
        resolved = np.dtype(dt)
    except TypeError:
        resolved = None
    if resolved is not None and resolved.kind in "fiub":
        dtype = torch.from_numpy(np.zeros(0, resolved)).dtype
        return NARROW_64.get(dtype, dtype)
    _warn_once(
        dt,
        f"PLink: channel dtype {dt!r} is not stageable across the "
        f"host/device boundary; falling back to float32. The compile-time "
        f"legalization pass rejects such placements — this program was "
        f"built without it.",
    )
    return torch.float32


def _np(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (bfloat16, which numpy lacks, as float32)."""
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@dataclass
class PLinkStats:
    launches: int = 0
    tokens_in: int = 0
    tokens_out: int = 0
    idle_signals: int = 0
    # boundary wall-time split (per launch, summed): host-side packing into
    # the staging ring plus the H2D enqueue, the launch plus the D2H enqueue,
    # readiness polling on the in-flight event, and the masked write-back
    # into host FIFOs
    stage_ns: int = 0
    dispatch_ns: int = 0
    sync_ns: int = 0
    retire_ns: int = 0
    tests: int = 0  # scheduler profiling contract


# Staging ring depth and in-flight launch cap.  _N_SLOTS > _MAX_INFLIGHT + 1
# guarantees the slot being packed is never one a still-in-flight launch may
# read: the busy-slot skip in ``_stage_inputs`` enforces it structurally.
_N_SLOTS = 4
_MAX_INFLIGHT = 2


class PLink:
    """Host-side controller for one device partition.

    Duck-types the actor-machine `invoke` contract so the scheduler treats it as
    a normal actor on its thread (the paper schedules PLink on p1).
    """

    # PLink paints its own lane track (stage/dispatch/sync/retire spans);
    # the scheduler must not double-paint its invokes as actor spans.
    trace_self = True

    def __init__(self, program: DeviceProgram, env, name: str = "plink"):
        self.program = program
        self.env = env  # PortEnv: host FIFO endpoints for the boundary ports
        self.name = name
        self.state = program.init_state
        self.stats = PLinkStats()
        self.k = max(1, program.megastep_k)
        self.device = program.device
        self._cuda = self.device.type == "cuda"
        # streamtrace: recorder captured once at construction; readiness
        # polls accumulate into _sync_acc and flush as ONE sync span per
        # retire, so the event count stays O(launches)
        self.recorder = _trace_current()
        self._track = f"lane:{name}"
        self._sync_acc = 0
        self._sync_t0 = 0
        # in-flight launches, oldest first: (outs, idle, n_in, slot, event).
        # On CUDA, outs/idle are the pinned host copies the event guards.
        self.inflight: Deque[Tuple[Dict, Any, int, int, Any]] = deque()
        self.device_idle = False
        # minimal Actor-duck for the scheduler
        self.actor = type("A", (), {"name": name})()
        # preallocated staging ring: per slot, per boundary port, one
        # (k, block) value buffer + mask (pinned on CUDA) reused across
        # launches, with numpy views for packing (None for bfloat16)
        shape = (self.k, program.block)
        self._slots = []
        for _ in range(_N_SLOTS):
            slot = {}
            for (a, p, dt) in program.in_ports:
                vals = torch.zeros(shape, dtype=_host_dtype(dt), pin_memory=self._cuda)
                mask = torch.zeros(shape, dtype=torch.bool, pin_memory=self._cuda)
                vview = None if vals.dtype == torch.bfloat16 else vals.numpy()
                slot[f"{a}.{p}"] = (vals, mask, vview, mask.numpy())
            self._slots.append(slot)
        # per-slot pinned D2H buffers, allocated at first use per output shape
        self._out_bufs = [dict() for _ in range(_N_SLOTS)]
        self._slot = 0

    # -- helpers ---------------------------------------------------------------
    def _phase(self, name: str, t0_ns: int, dur_ns: int, **args) -> None:
        """One boundary-phase span on this lane's track."""
        rec = self.recorder
        if rec is not None:
            rec.complete(self._track, name, "plink", t0_ns, dur_ns, args)

    def _flush_sync(self) -> None:
        """Emit accumulated readiness-poll time as a single sync span."""
        if self._sync_acc:
            self._phase("sync", self._sync_t0, self._sync_acc)
            self._sync_acc = 0

    def _plan(self) -> Dict[str, int]:
        """Tokens stageable per boundary port right now: whole staging
        granules, lane-aligned across each internal component's ports,
        capped at one block."""
        block = self.program.block
        quanta = self.program.in_quanta
        plan: Dict[str, int] = {}
        for keys in self.program.in_groups.values():
            g = min(
                min(self.env.inputs[k].count(), block) // quanta[k]
                for k in keys
            )
            if g > 0:
                for k in keys:
                    plan[k] = g * quanta[k]
        return plan

    def _host_buf(self, slot: int, key: str, like: torch.Tensor) -> torch.Tensor:
        bufs = self._out_bufs[slot]
        buf = bufs.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            bufs[key] = buf
        return buf

    def _stage_inputs(self):
        """Drain host FIFOs into the next free staging-ring slot and copy it
        to the device.

        One ``(k, block)`` chunk stack per boundary port (a plain
        ``(block,)`` row when ``k == 1``).  Chunks are planned one at a time
        (``_plan`` re-runs between rows), which drains the FIFOs in exactly
        the order k sequential one-block launches would; every position not
        written this launch is zeroed with its mask False, so a reused buffer
        never leaks a previous launch's tokens into padding.
        """
        t0 = time.perf_counter_ns()
        busy = {s for (_o, _i, _n, s, _e) in self.inflight}
        idx = self._slot
        while idx in busy:
            idx = (idx + 1) % _N_SLOTS
        slot = self._slots[idx]
        total = 0
        for j in range(self.k):
            plan = self._plan()
            any_n = False
            for (a, p, _dt) in self.program.in_ports:
                key = f"{a}.{p}"
                vals, _mask, vview, mview = slot[key]
                n = plan.get(key, 0)
                if n:
                    any_n = True
                    ep = self.env.inputs[key]
                    view = (
                        ep.peek_view(n)
                        if hasattr(ep, "peek_view") else None
                    )
                    data = view if view is not None else ep.read(n)
                    if vview is not None:
                        vview[j, :n] = np.asarray(data, dtype=vview.dtype)
                    else:
                        vals[j, :n] = torch.from_numpy(np.asarray(data, np.float32))
                    if view is not None:
                        ep.commit(n)
                if vview is not None:
                    vview[j, n:] = 0
                else:
                    vals[j, n:] = 0
                mview[j, :n] = True
                mview[j, n:] = False
                total += n
            if not any_n and j + 1 < self.k:
                # out of stageable granules: the remaining chunks are pure
                # padding (zero values, all-False masks)
                for vals, _mask, _v, mview in slot.values():
                    vals[j + 1:] = 0
                    mview[j + 1:] = False
                break
        staged = {}
        for (a, p, _dt) in self.program.in_ports:
            key = f"{a}.{p}"
            vals, mask, _v, _m = slot[key]
            if self.k == 1:
                vals, mask = vals[0], mask[0]
            if self._cuda:
                vals = vals.to(self.device, non_blocking=True)
                mask = mask.to(self.device, non_blocking=True)
            staged[key] = (vals, mask)
        dt_ns = time.perf_counter_ns() - t0
        self.stats.stage_ns += dt_ns
        self._phase("stage", t0, dt_ns, tokens=total, k=self.k)
        return staged, total, idx

    def _retire(self, outs, idle) -> int:
        """Write one completed launch's *boundary* outputs into host FIFOs,
        from their host copies — never internal FIFO or actor state, which
        stays on the device."""
        t0 = time.perf_counter_ns()
        moved = 0
        for key, (vals, mask) in outs.items():
            # (k, block) boolean indexing flattens row-major = chunk order,
            # so megastep outputs retire in exactly per-iteration order
            keep = _np(vals)[_np(mask)]
            if keep.size:
                # a device->device ArrayFifo queues the array itself; a
                # RingFifo carries host tokens boxed via tolist() — native
                # Python floats, not numpy scalars
                ep = self.env.outputs[key]
                if isinstance(getattr(ep, "fifo", None), ArrayFifo):
                    ep.write(keep)
                else:
                    ep.write(keep.tolist())
                moved += int(keep.size)
        self.device_idle = bool(idle)
        if self.device_idle:
            self.stats.idle_signals += 1
        dt_ns = time.perf_counter_ns() - t0
        self.stats.retire_ns += dt_ns
        self.stats.tokens_out += moved
        self._phase("retire", t0, dt_ns, tokens=moved, idle=self.device_idle)
        return moved

    def _launch(self, staged, slot: int):
        """Launch the step; on CUDA also enqueue the D2H copies of the
        boundary outputs and the idle flag, then record the event that says
        they have landed.  Returns (outs, idle, event) for the retire path."""
        if not self._cuda:
            state, outs, idle = self.program.launch(self.state, staged)
            self.state = state
            return outs, idle, None
        with torch.cuda.device(self.device):
            state, outs, idle = self.program.launch(self.state, staged)
            self.state = state
            host = {}
            for key, (vals, mask) in outs.items():
                hv = self._host_buf(slot, key, vals)
                hm = self._host_buf(slot, key + "#mask", mask)
                hv.copy_(vals, non_blocking=True)
                hm.copy_(mask, non_blocking=True)
                host[key] = (hv, hm)
            hidle = self._host_buf(slot, "#idle", idle)
            hidle.copy_(idle, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return host, hidle, event

    # -- scheduler contract ------------------------------------------------------
    @property
    def pending(self) -> bool:
        """True while a device step is in flight — the scheduler must not
        declare quiescence until the step retires (its outputs may wake
        downstream actors)."""
        return len(self.inflight) > 0

    def invoke(self, max_execs: int = 1) -> int:
        progress = 0
        # 1) retire completed launches, oldest first, without blocking:
        # readiness is the launch's event, recorded after its D2H copies
        while self.inflight:
            outs, idle, _n_in, _slot, event = self.inflight[0]
            t0 = time.perf_counter_ns()
            ready = event is None or event.query()
            poll_ns = time.perf_counter_ns() - t0
            self.stats.sync_ns += poll_ns
            if self.recorder is not None:
                if not self._sync_acc:
                    self._sync_t0 = t0
                self._sync_acc += poll_ns
            if not ready:
                if len(self.inflight) >= _MAX_INFLIGHT:
                    return progress  # pipeline full; never block (§III-D)
                break  # head still computing — overlap: stage the next block
            self.inflight.popleft()
            self._flush_sync()
            progress += self._retire(outs, idle)
        # 2) stage + launch the next block while up to _MAX_INFLIGHT - 1
        # earlier launches compute.  Never launch a step whose retirement
        # could overflow an output FIFO: every launch still in flight may
        # retire up to k*block valid tokens per port, and a device->device
        # lane (or a slow host consumer) has no other backpressure point.
        has_inputs = bool(self.program.in_ports)
        if has_inputs and not self._plan():
            # nothing stageable: return before touching the staging ring
            return progress
        need = (len(self.inflight) + 1) * self.k * self.program.block
        for ep in self.env.outputs.values():
            cap = getattr(getattr(ep, "fifo", None), "capacity", None)
            if cap is not None and ep.space() < min(need, cap):
                return progress
        # chaos site BEFORE staging: an injected lane death leaves the
        # host FIFOs untouched
        chaos_mod.poke(f"plink:{self.name}")
        staged, n_in, slot = self._stage_inputs()
        if n_in == 0 and has_inputs:
            return progress
        t0 = time.perf_counter_ns()
        outs, idle, event = self._launch(staged, slot)
        dt_ns = time.perf_counter_ns() - t0
        self.stats.dispatch_ns += dt_ns
        self._phase("dispatch", t0, dt_ns, tokens=n_in, k=self.k)
        self.inflight.append((outs, idle, n_in, slot, event))
        self._slot = (slot + 1) % _N_SLOTS
        self.stats.launches += 1
        self.stats.tokens_in += n_in
        progress += n_in
        return progress
