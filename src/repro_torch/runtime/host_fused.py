"""Fused block-wise execution of static-rate host regions.

The scheduler's per-token interpretation charges every software token a full
actor-machine round trip (condition tests, dict lookups, Python-float
boxing).  For a *static-rate* region that tax buys nothing — rates are known,
guards are absent — so the middle-end lowers such regions to a
``HostFusedSpec`` (``repro_torch.ir.fusion.build_host_fused``) and the runtimes
fire them through this executor instead: bulk-slice the boundary FIFOs in,
evaluate the region's ``StreamProgram`` once with the float64 numpy
evaluator (``kernels.stream_fused.fused_stream_np``), bulk-slice the results
out.  One numpy pass over a block of tokens replaces ``members x block``
interpreted firings.

Bit-identity with the interpreted path is by construction: numpy float64
elementwise ops compute exactly what the members' scalar fire functions
compute on Python floats (IEEE doubles), and ``matmul8`` performs the
identical float32 round trip the interpreted actor performs per 8-block.

The members' actor machines are NOT discarded — they stay wrapped inside the
region (their channels, including the internal ones, still exist), and the
executor falls back to per-token interpretation whenever the fused fast path
cannot run:

  * fewer than one whole staging quantum of input is available (a
    dynamic-rate stream tail, or a serve-mode client submitting torn
    chunks),
  * the output FIFOs lack space for a whole quantum (downstream
    backpressure),
  * a previous interpreted round left tokens on an *internal* channel (the
    fast path bypasses internal channels, so it must never run ahead of
    in-flight interpreted tokens).

Interpretation is bounded to ONE region iteration per invocation, with
per-member firing budgets taken from the repetition vector: completing the
iteration empties every internal channel (stream ops conserve tokens per
wire), after which the fast path resumes instead of interpretation
swallowing the whole backlog.  The two paths interleave freely without
reordering or changing a single bit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.actor_machine import AMStats

__all__ = ["HostFusedRegion", "bulk_read", "attach_host_fused"]


class _ActorTag:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


def bulk_read(ep, n: int) -> np.ndarray:
    """Drain ``n`` tokens from a reader endpoint into one numpy array,
    through the zero-copy contiguous window when the ring permits it.

    The dtype is whatever numpy infers from the tokens themselves: Python
    floats become float64, device-retired ``np.float32`` scalars stay
    float32 — so downstream vectorized arithmetic promotes exactly the way
    the scalar interpreter's per-token expressions do (NEP 50)."""
    view = ep.peek_view(n)
    if view is None:  # window wraps: fall back to the boxed read
        return np.asarray(ep.read(n))
    arr = np.asarray(view)
    ep.commit(n)
    return arr


class HostFusedRegion:
    """Block-wise actor machine for one fused host region.

    Duck-types the scheduler's ``invoke`` contract (like PLink), so a thread
    partition — or a serve-mode ``SessionPipeline`` — fires it exactly like
    any other instance on its round-robin list.
    """

    pending = False  # no async work: quiescence needs nothing special

    def __init__(
        self,
        name: str,
        spec,  # repro_torch.ir.fusion.HostFusedSpec
        machines: Dict[str, object],  # member -> ActorMachine|BasicController
        in_eps: Sequence,             # reader endpoints, program input order
        out_eps: Sequence,            # writer endpoints, program output order
        internal_fifos: Sequence,     # the region's internal channels
    ):
        self.name = name
        self.spec = spec
        self.machines = dict(machines)
        self.in_eps = list(in_eps)
        self.out_eps = list(out_eps)
        self.internal = list(internal_fifos)
        self.block = max(spec.block, spec.quantum)
        self.actor = _ActorTag(name)
        self.stats = AMStats()
        # telemetry key carries the member list so profile ingestion can
        # split the fused time back over the authored actors
        self.telemetry_key = "hostfused:" + "+".join(spec.members)
        self.fast_invocations = 0
        self.interp_invocations = 0
        self.tokens_fused = 0

    # -- scheduler contract --------------------------------------------------
    def invoke(self, max_execs: int = 1_000_000) -> int:
        self.stats.invocations += 1
        if not any(f.occupancy() for f in self.internal):
            # fast path: only when no interpreted iteration is in flight on
            # the internal channels (the vectorized call bypasses them and
            # must never overtake in-flight tokens)
            q = self.spec.quantum
            # honor the scheduler's invoke budget like any other instance:
            # cap the block at the quanta whose member-firing equivalent
            # fits max_execs (floored at one quantum — less cannot execute)
            budget_quanta = max(max_execs // self.spec.fires_per_quantum, 1)
            n = min(ep.count() for ep in self.in_eps)
            n = min(n, self.block, budget_quanta * q)
            n -= n % q
            if n > 0:
                space = min(ep.space() for ep in self.out_eps)
                n = min(n, space - space % q)
            if n > 0:
                ins = [bulk_read(ep, n) for ep in self.in_eps]
                from repro_torch.kernels.stream_fused import fused_stream_np

                outs = fused_stream_np(ins, self.spec.program)
                for ep, arr in zip(self.out_eps, outs):
                    # list(arr) keeps the numpy scalar type per token (a
                    # float32 stream stays float32 downstream, exactly like
                    # the interpreted members would leave it)
                    ep.write(list(arr))
                execs = (n // q) * self.spec.fires_per_quantum
                self.stats.execs += execs
                self.fast_invocations += 1
                self.tokens_fused += n
                return execs
        # dynamic-rate tail / blocked outputs / in-flight residue: per-token
        # interpretation, bounded to ONE region iteration
        execs = self._interpret_iteration(max_execs)
        if execs:
            self.interp_invocations += 1
            self.stats.execs += execs
        else:
            self.stats.waits += 1
        return execs

    def _interpret_iteration(self, max_execs: int) -> int:
        """Advance the member machines by at most one region iteration.

        Budgets come from the repetition vector: with ``k_m`` total firings
        so far and ``f_m`` firings per iteration, the region is inside
        iteration ``I = max_m ceil(k_m / f_m)``; each member may fire up to
        ``I*f_m - k_m`` more times (a fresh iteration starts when none is
        partial).  Completing the iteration empties every internal channel —
        stream ops conserve tokens per wire — so the fused fast path resumes
        on the next invocation instead of interpretation swallowing the
        whole backlog.  Firing fewer times (tokens or space missing) just
        leaves the iteration partial for a later invocation.
        """
        machines = list(self.machines.values())
        fs = self.spec.fires_each
        ks = [m.stats.execs for m in machines]
        iteration = max(
            (k + f - 1) // f for k, f in zip(ks, fs)
        )
        if all(k == iteration * f for k, f in zip(ks, fs)):
            iteration += 1  # no partial iteration: allow starting the next
        execs = 0
        for mach, k, f in zip(machines, ks, fs):
            budget = min(iteration * f - k, max_execs - execs)
            if budget > 0:
                execs += mach.invoke(budget)
        return execs

    # -- introspection -------------------------------------------------------
    @property
    def members(self) -> List[str]:
        return list(self.spec.members)

    def __repr__(self) -> str:
        return (
            f"HostFusedRegion({self.name!r}, members={self.members}, "
            f"q={self.spec.quantum}, fused_tokens={self.tokens_fused})"
        )


def attach_host_fused(
    module,
    instances: Dict[str, object],
    readers: Dict[str, Dict],
    writers: Dict[str, Dict],
    fifo_of: Dict,  # channel key -> FIFO (internal-channel lookup)
) -> Dict[str, HostFusedRegion]:
    """Wrap each ``meta["host_fused"]`` group's member instances into one
    ``HostFusedRegion``.

    Mutates ``instances``: members are popped and replaced by ``{gid:
    region}`` entries (also returned).  Shared by the thread scheduler
    (``HostRuntime``/``HeteroRuntime``) and the serve-mode
    ``SessionPipeline`` so the two can never drift on how a region is wired.
    """
    specs = module.meta.get("host_fused") or {}
    regions: Dict[str, HostFusedRegion] = {}
    for gid, spec in specs.items():
        if not all(m in instances for m in spec.members):
            continue  # members not instantiated here (e.g. stripped in serve)
        machines = {m: instances.pop(m) for m in spec.members}
        in_eps = [readers[k[2]][k[3]] for k in spec.in_keys]
        out_eps = [writers[k[0]][k[1]] for k in spec.out_keys]
        internal = [fifo_of[k] for k in spec.internal_keys]
        region = HostFusedRegion(gid, spec, machines, in_eps, out_eps, internal)
        instances[gid] = region
        regions[gid] = region
    return regions
