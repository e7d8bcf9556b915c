"""The compiler middle-end: passes over the typed dataflow IR.

``lower()`` is the one entry point every backend uses::

    module = lower(net_or_graph, xcf, block=4096)   # runs the pipeline
    HostRuntime(module) / HeteroRuntime(module) / compile_partition(module)

Default pipeline (in order):

  lower-frontend       Network/ActorGraph -> IRModule (rates, dtypes)
  legalize-placement   XCF -> regions; rejects illegal placements with
                       actionable GraphErrors (subsumes the partitioner's
                       ad-hoc checks + compile-time device-dtype validation)
  eliminate-dead       drops actors (and their channels) that cannot reach
                       any sink — they can never affect an observable output
  infer-fifo-depths    resolves every channel depth: XCF-pinned > authored >
                       inferred (rate- and boundary-aware); replaces the old
                       mutate-the-graph-per-XCF depth rebuild
  analyze-rates        solves the SDF balance equations (repro_torch.analysis):
                       ``meta["repetition"]`` gets the repetition vector,
                       inconsistent-rate networks get an SB101 diagnostic
  detect-sdf-regions   finds maximal static-rate regions inside each device
                       partition (never across a partition boundary) AND
                       inside each software partition (stream-op members
                       only — candidates for fused block execution on host)
  streamcheck          compile-time dataflow verification (repro_torch.analysis):
                       deadlock simulation, buffer/block sufficiency, and
                       the boundedness/liveness/placement lints.  Under the
                       default ``check=True`` policy error-severity findings
                       raise ``AnalysisError`` here — before any runtime
                       thread spins up; ``check="warn"`` collects findings
                       in ``meta["diagnostics"]`` without rejecting, and
                       ``check=False`` skips both analysis passes
  fuse-sdf-regions     collapses each device SDF region into one fused actor
                       (CUDA stream kernel when specs allow, composed torch
                       otherwise)
  fuse-sdf-host-regions lowers each software SDF region to a
                       ``HostFusedSpec`` in ``meta["host_fused"]``: the
                       runtimes drive the region as ONE vectorized numpy
                       block executor instead of N per-token interpreters,
                       bit-identical by construction (see
                       ``repro_torch.runtime.host_fused`` + docs/runtime.md).
                       Unlike device fusion nothing is rewritten — members
                       and channels survive, so the per-token interpreted
                       fallback stays available for dynamic-rate tails

Every pass appends a full module dump to ``module.trace`` —
``Program.ir_dump()`` renders it.

Copy of ``repro/ir/passes.py``.  Edits: the two docstrings that name the
fused codegen say CUDA stream kernel / composed torch where the reference
says Pallas / composed-jnp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch import analysis
from repro_torch.core.graph import ActorGraph, GraphError
from repro_torch.core.xcf import XCF
from repro_torch.ir import fusion
from repro_torch.ir.ir import IRActor, IRChannel, IRModule, RateSig, Region

__all__ = [
    "PassContext",
    "Pass",
    "PassPipeline",
    "default_pipeline",
    "lower",
    "legalize_xcf",
    "device_dtype_ok",
    "resolve_megastep",
    "DEFAULT_MEGASTEP_K",
]

# How many repetition-vector iterations one device launch covers when the
# user asks for ``megastep="auto"``.  Four keeps the staged burst (2*k*block
# tokens of crossing-FIFO headroom) modest while amortizing the per-launch
# stage/dispatch/sync/retire boundary cost 4x — the runtime clamps further
# per partition (FIFO depths, statefulness); see
# ``runtime.device_runtime.compile_partition``.
DEFAULT_MEGASTEP_K = 4


def resolve_megastep(megastep) -> int:
    """Resolve a ``megastep`` option to a target chunk count.

    ``"auto"`` -> ``DEFAULT_MEGASTEP_K``; ``False``/``None`` -> 1 (one
    repetition-vector block per launch, the pre-megastep behavior); an int
    is taken literally (floored at 1).  An int already resolved by a prior
    call passes through unchanged, so the value stored in
    ``module.meta["megastep"]`` can be re-resolved safely.
    """
    if megastep is None or megastep is False:
        return 1
    if megastep == "auto":
        return DEFAULT_MEGASTEP_K
    return max(1, int(megastep))


@dataclass
class PassContext:
    """Inputs the pipeline closes over (never stored in the module)."""

    graph: ActorGraph
    xcf: Optional[XCF] = None
    default_depth: int = 4096
    block: int = 1024
    fuse: bool = True
    opt_level: int = 1  # 2 adds algebraic folding (not bit-preserving)
    # megastep policy: "auto" (default) targets DEFAULT_MEGASTEP_K
    # repetition-vector iterations per device launch, False/1 disables,
    # an int pins the target.  Depth inference sizes crossing FIFOs for it
    # and the resolved target lands in ``meta["megastep"]``; the device
    # backend clamps per partition.
    megastep: object = "auto"
    # streamcheck policy: True/"error" rejects error-severity findings with
    # AnalysisError, "warn" collects them in meta["diagnostics"] without
    # rejecting, False skips the analysis passes entirely
    check: object = True


class Pass:
    name = "pass"

    def run(self, module: Optional[IRModule], ctx: PassContext) -> IRModule:
        raise NotImplementedError


class PassPipeline:
    """Runs passes in order, recording a dump after each for ``ir_dump``.

    ``record=False`` skips the per-pass dump rendering — used by hot callers
    (e.g. the partitioner legalizing every DSE candidate) that never read
    the trace."""

    def __init__(self, passes: Sequence[Pass], *, record: bool = True):
        self.passes = list(passes)
        self.record = record

    @property
    def names(self) -> List[str]:
        return [p.name for p in self.passes]

    def run(self, ctx: PassContext) -> IRModule:
        module: Optional[IRModule] = None
        for p in self.passes:
            module = p.run(module, ctx)
            if self.record:
                module.record(p.name)
        assert module is not None, "empty pipeline"
        return module


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------


class LowerFrontend(Pass):
    """ActorGraph -> IRModule: rate signatures, channel dtypes, no regions."""

    name = "lower-frontend"

    def run(self, module, ctx: PassContext) -> IRModule:
        g = ctx.graph
        g.validate()
        mod = IRModule(name=g.name, source=g)
        for name, a in g.actors.items():
            mod.actors[name] = IRActor(
                name=name,
                inputs=list(a.inputs),
                outputs=list(a.outputs),
                rate=RateSig.of(a),
                device_ok=a.device_ok,
                host_only_reason=a.host_only_reason,
                impl=a,
            )
        for ch in g.channels:
            mod.channels.append(
                IRChannel(
                    src=ch.src, src_port=ch.src_port,
                    dst=ch.dst, dst_port=ch.dst_port,
                    dtype=g.actors[ch.src].port(ch.src_port).dtype,
                    authored_depth=ch.depth,
                )
            )
        return mod


def device_dtype_ok(dt: str) -> bool:
    """Token dtypes the device boundary can stage as a dense numeric buffer."""
    if dt == "bfloat16":  # np.dtype() needs ml_dtypes for this one
        return True
    try:
        return np.dtype(dt).kind in "fiub"
    except TypeError:
        return False


class LegalizePlacement(Pass):
    """XCF -> regions, with every placement rule checked up front.

    Subsumes the checks previously scattered across ``XCF.validate``, the
    partitioner, and the runtimes: unknown/duplicate/unassigned instances,
    host-only actors on hw, partitions requesting a code generator the
    toolchain does not have, and device-partition channels whose token dtype
    cannot cross a host/device (or device/device) boundary.  Any number of
    hw partitions is legal — each becomes its own region, compiled into its
    own device program behind its own PLink lane.
    """

    name = "legalize-placement"

    KNOWN_GENERATORS = ("hw", "sw")

    def run(self, module: IRModule, ctx: PassContext) -> IRModule:
        if ctx.xcf is None:
            module.regions["t0"] = Region(
                "t0", "sw", "x86_64", list(module.actors)
            )
            return module
        xcf = ctx.xcf
        seen: Set[str] = set()
        for pid, p in xcf.partitions.items():
            if p.code_generator not in self.KNOWN_GENERATORS:
                raise GraphError(
                    f"{module.name}: XCF partition {pid!r} requests code "
                    f"generator {p.code_generator!r}, which this toolchain "
                    f"does not provide (known: "
                    f"{sorted(self.KNOWN_GENERATORS)}; the XCF declares "
                    f"{sorted(xcf.code_generators)})"
                )
            for a in p.instances:
                if a not in module.actors:
                    raise GraphError(
                        f"{module.name}: XCF partition {pid!r} places unknown "
                        f"actor {a!r} (known: {sorted(module.actors)})"
                    )
                if a in seen:
                    raise GraphError(
                        f"{module.name}: XCF places {a!r} in multiple "
                        f"partitions"
                    )
                seen.add(a)
                ir = module.actors[a]
                if p.code_generator == "hw" and not ir.device_ok:
                    raise GraphError(
                        f"{module.name}: XCF places {a!r} on hw partition "
                        f"{pid!r} but it is host-only "
                        f"({ir.host_only_reason or 'no reason recorded'})"
                    )
            module.regions[pid] = Region(
                pid, p.code_generator, p.pe, list(p.instances)
            )
        missing = set(module.actors) - seen
        if missing:
            raise GraphError(
                f"{module.name}: XCF leaves actors unassigned: "
                f"{sorted(missing)}"
            )
        hw = module.hw_actors()
        for ch in module.channels:
            if (ch.src in hw or ch.dst in hw) and not device_dtype_ok(ch.dtype):
                raise GraphError(
                    f"{module.name}: channel {ch} has dtype {ch.dtype!r}, "
                    f"which cannot be staged across a device partition "
                    f"boundary — give the ports a concrete numeric dtype or "
                    f"keep both endpoints on sw partitions"
                )
        return module


class EliminateDead(Pass):
    """Remove actors with no path to any sink.

    A sink (an actor with no output ports) is the only observable effect a
    network has; anything that cannot reach one can never influence an
    output, so it — and its channels — are dropped before the backends see
    the module.  Dead actors *fed by* a live actor are kept, though:
    removing them would sever the live producer's output channel and leave
    a dangling port the runtimes have no endpoint for.  Networks with no
    sinks at all are left untouched.
    """

    name = "eliminate-dead"

    def run(self, module: IRModule, ctx: PassContext) -> IRModule:
        sinks = [n for n, a in module.actors.items() if not a.outputs]
        if not sinks:
            return module
        live: Set[str] = set()
        work = list(sinks)
        while work:
            n = work.pop()
            if n in live:
                continue
            live.add(n)
            work.extend(module.predecessors(n) - live)
        # keep the forward closure of the live set: a dead region consuming
        # from a live actor must survive so every live output stays wired
        work = list(live)
        while work:
            n = work.pop()
            for m in module.successors(n):
                if m not in live:
                    live.add(m)
                    work.append(m)
        dead = sorted(set(module.actors) - live)
        if dead:
            for n in dead:
                del module.actors[n]
            module.channels = [
                c for c in module.channels if c.src in live and c.dst in live
            ]
            for r in module.regions.values():
                r.actors = [a for a in r.actors if a in live]
            module.meta["eliminated"] = dead
        return module


class InferFifoDepths(Pass):
    """Resolve every channel depth without touching the authored graph.

    Priority: XCF-pinned > authored > inferred.  Inference is rate- and
    boundary-aware: a channel crossing the device partition needs room for
    two in-flight PLink *launches* — each covering up to ``megastep`` blocks
    (``meta["megastep"]``, the resolved chunk count per launch) — so staging
    launch N+1 can overlap launch N's dispatch without the FIFO wedging; a
    multi-rate edge needs at least a couple of firings' worth of tokens.
    """

    name = "infer-fifo-depths"

    def run(self, module: IRModule, ctx: PassContext) -> IRModule:
        pinned = ctx.xcf.fifo_depths() if ctx.xcf is not None else {}
        hw_of = module.hw_assignment()
        k = resolve_megastep(ctx.megastep)
        module.meta["megastep"] = k
        for ch in module.channels:
            ch.xcf_depth = pinned.get(ch.key)
            rate = max(
                module.actors[ch.src].rate.produce_rate(ch.src_port),
                module.actors[ch.dst].rate.consume_rate(ch.dst_port),
                1,
            )
            # a channel crossing *any* device boundary — host<->hw or
            # hw<->hw between two different partitions — stages whole PLink
            # launches of k blocks each and needs room for two of them
            # (double buffering, now megastep-sized)
            crossing = (
                (ch.src in hw_of or ch.dst in hw_of)
                and hw_of.get(ch.src) != hw_of.get(ch.dst)
            )
            if crossing:
                ch.inferred_depth = max(ctx.default_depth, 2 * k * ctx.block)
            else:
                ch.inferred_depth = max(ctx.default_depth, 2 * rate)
        return module


class DetectSDFRegions(Pass):
    """Find maximal static-rate (SDF) regions inside each partition.

    Members must be guard-free single-action actors (``RateSig.static``);
    regions are the connected components of such actors over one partition's
    internal channels — a channel between two *different* hw partitions is a
    staged PLink-lane boundary and never fuses across.  A region must
    additionally be *convex*: no path between two members may pass through
    an outside actor — fusing a non-convex group would put the outsider both
    upstream and downstream of the fused actor, i.e. introduce a cycle.
    Non-convex groups are skipped (recorded in
    ``meta["sdf_groups_skipped"]``).  Only multi-actor regions are worth
    fusing.

    Software partitions are scanned too (``meta["sdf_host_groups"]``): host
    candidates are additionally required to carry a declarative
    ``stream_op`` spec, be stateless, and have both input and output ports —
    sources/sinks run arbitrary Python (collectors, generators) that a block
    executor cannot vectorize, and spec-less members would force the whole
    group back to interpretation anyway.
    """

    name = "detect-sdf-regions"

    @staticmethod
    def _is_convex(module: IRModule, group: Set[str]) -> bool:
        succs: Dict[str, Set[str]] = {}
        preds: Dict[str, Set[str]] = {}
        for ch in module.channels:
            succs.setdefault(ch.src, set()).add(ch.dst)
            preds.setdefault(ch.dst, set()).add(ch.src)

        def closure(seed: Set[str], edges: Dict[str, Set[str]]) -> Set[str]:
            out: Set[str] = set()
            work = list(seed)
            while work:
                n = work.pop()
                for m in edges.get(n, ()):
                    if m not in out:
                        out.add(m)
                        work.append(m)
            return out

        downstream = closure(group, succs) - group
        upstream = closure(group, preds) - group
        return not (downstream & upstream)

    def run(self, module: IRModule, ctx: PassContext) -> IRModule:
        from repro_torch.ir.ir import connected_components

        sdf, skipped = [], []
        for hw in module.hw_regions():
            static = {
                a for a in hw.actors if module.actors[a].rate.static
            }
            comp = connected_components(static, module.channels)
            groups: Dict[str, List[str]] = {}
            for a in static:
                groups.setdefault(comp[a], []).append(a)
            for g in groups.values():
                if len(g) < 2:
                    continue
                (sdf if self._is_convex(module, set(g)) else skipped).append(
                    sorted(g)
                )
        if sdf:
            module.meta["sdf_groups"] = sorted(sdf)
        if skipped:
            module.meta["sdf_groups_skipped"] = sorted(skipped)

        host, host_skipped = [], []
        for sw in module.sw_regions():
            cand = {
                a for a in sw.actors if self._host_fusable(module.actors[a])
            }
            comp = connected_components(cand, module.channels)
            groups: Dict[str, List[str]] = {}
            for a in cand:
                groups.setdefault(comp[a], []).append(a)
            for g in groups.values():
                if len(g) < 2:
                    continue
                (host if self._is_convex(module, set(g))
                 else host_skipped).append(sorted(g))
        if host:
            module.meta["sdf_host_groups"] = sorted(host)
        if host_skipped:
            module.meta["sdf_host_groups_skipped"] = sorted(host_skipped)
        return module

    @staticmethod
    def _host_fusable(ir) -> bool:
        return (
            ir.rate.static
            and bool(ir.inputs)
            and bool(ir.outputs)
            and ir.impl is not None
            and getattr(ir.impl, "stream_op", None) is not None
            and not getattr(ir.impl, "initial_state", None)
        )


class AnalyzeRates(Pass):
    """Solve the SDF balance equations (see ``repro_torch.analysis.rates``).

    Stores the repetition vector — minimal fires-per-iteration per static
    component, 1 for dynamic/unconstrained actors — in
    ``meta["repetition"]`` and starts the module's diagnostics collection.
    Runs before region detection so fusion and the device staging plan can
    consume region-restricted vectors instead of re-deriving lcm math, and
    before fusion so SB101 names authored actors.  Rejection is deferred to
    the ``streamcheck`` pass so a single AnalysisError carries *all*
    findings.
    """

    name = "analyze-rates"

    def run(self, module: IRModule, ctx: PassContext) -> IRModule:
        if ctx.check is False:
            return module
        analysis.run_rate_analysis(module)
        return module


class StreamCheck(Pass):
    """Compile-time dataflow verification (see ``repro_torch.analysis``).

    Deadlock simulation against resolved FIFO depths (SB102), buffer and
    staging-block sufficiency (SB103/SB104), and the SB2xx lints.  Placed
    after region detection (SB104 needs the hw regions, SB202 the would-be
    groups) but before fusion, so every diagnostic names actors the user
    authored.  ``ctx.check`` selects the policy: True/"error" raises
    ``AnalysisError`` on error-severity findings, "warn" only collects,
    False skipped this pass before it ran.
    """

    name = "streamcheck"

    def run(self, module: IRModule, ctx: PassContext) -> IRModule:
        if ctx.check is False:
            return module
        diags = analysis.run_streamcheck(module, block=ctx.block)
        if diags.has_errors and ctx.check in (True, "error"):
            raise analysis.AnalysisError(module.name, diags)
        return module


class FuseSDFRegions(Pass):
    """Collapse each detected SDF region into one fused device actor.

    The fused actor inherits the region's boundary channels (ports renamed
    ``member__PORT``) with their resolved depths; internal channels vanish.
    Codegen is the CUDA stream kernel when every member carries a
    ``stream_op`` spec, else a composed torch ``vector_fire``.  Disabled with
    ``fuse=False`` (used by the unfused baseline in benchmarks and the
    bit-equivalence tests).
    """

    name = "fuse-sdf-regions"

    def run(self, module: IRModule, ctx: PassContext) -> IRModule:
        groups = module.meta.get("sdf_groups", [])
        if not ctx.fuse or not groups:
            return module
        hw_of = module.hw_assignment()
        fused_meta: Dict[str, Dict] = {}
        for i, members in enumerate(groups):
            hw = module.regions[hw_of[members[0]]]
            name = f"fused{i}"
            while name in module.actors:
                name += "_"
            build = fusion.build_fused(
                module, members, name, opt_level=ctx.opt_level
            )
            mset = set(members)
            impl = build.actor
            module.actors[name] = IRActor(
                name=name,
                inputs=list(impl.inputs),
                outputs=list(impl.outputs),
                rate=RateSig.of(impl),
                device_ok=True,
                host_only_reason="",
                impl=impl,
                fused_from=build.members,
                codegen=build.codegen,
            )
            for m in members:
                del module.actors[m]
            keep: List[IRChannel] = []
            for ch in module.channels:
                s_in, d_in = ch.src in mset, ch.dst in mset
                if s_in and d_in:
                    continue  # internal: fused away
                if d_in:
                    ch.dst, ch.dst_port = (
                        name, build.in_port_of[(ch.dst, ch.dst_port)]
                    )
                elif s_in:
                    ch.src, ch.src_port = (
                        name, build.out_port_of[(ch.src, ch.src_port)]
                    )
                keep.append(ch)
            module.channels = keep
            hw.actors = [a for a in hw.actors if a not in mset] + [name]
            fused_meta[name] = {
                "members": list(build.members),
                "codegen": build.codegen,
                "ops": str(build.program) if build.program else None,
            }
        module.meta["fused"] = fused_meta
        return module


class FuseSDFHostRegions(Pass):
    """Lower each detected software SDF region to a ``HostFusedSpec``.

    Runs *after* device fusion so the recorded channel keys are the final
    (post-rewrite) ones — a host region bordering a device partition sees the
    fused device actor's renamed ports.  The module itself is untouched: the
    spec lands in ``meta["host_fused"]`` and the runtimes decide per
    invocation whether to fire the region as one vectorized block
    (``runtime.host_fused.HostFusedRegion``) or fall back to the members'
    per-token interpreters.  Groups whose members fall outside the stream-op
    palette are recorded in ``meta["host_fused_skipped"]`` and stay
    interpreted.  Disabled with ``fuse=False``, like device fusion.
    """

    name = "fuse-sdf-host-regions"

    def run(self, module: IRModule, ctx: PassContext) -> IRModule:
        groups = module.meta.get("sdf_host_groups", [])
        if not ctx.fuse or not groups:
            return module
        specs, skipped = {}, []
        for i, members in enumerate(groups):
            gid = f"hostfused{i}"
            while gid in module.actors:
                gid += "_"
            spec = fusion.build_host_fused(
                module, members, opt_level=ctx.opt_level, block=ctx.block
            )
            if spec is None:
                skipped.append(list(members))
                continue
            specs[gid] = spec
        if specs:
            module.meta["host_fused"] = specs
        if skipped:
            module.meta["host_fused_skipped"] = sorted(skipped)
        return module


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def default_pipeline() -> PassPipeline:
    return PassPipeline([
        LowerFrontend(),
        LegalizePlacement(),
        EliminateDead(),
        InferFifoDepths(),
        AnalyzeRates(),
        DetectSDFRegions(),
        StreamCheck(),
        FuseSDFRegions(),
        FuseSDFHostRegions(),
    ])


def _as_graph(src) -> ActorGraph:
    if isinstance(src, ActorGraph):
        return src
    if hasattr(src, "graph") and callable(src.graph):  # frontend Network
        return src.graph()
    raise GraphError(
        f"lower() expects an ActorGraph or frontend Network, got "
        f"{type(src).__name__}"
    )


def lower(
    src,
    xcf: Optional[XCF] = None,
    *,
    default_depth: int = 4096,
    block: int = 1024,
    fuse: bool = True,
    opt_level: int = 1,
    check: object = True,
    megastep: object = "auto",
) -> IRModule:
    """Lower a network/graph (+ optional XCF placement) through the default
    pipeline.  This is the only road from authored graphs to the backends.

    ``check`` is the streamcheck policy: True (default) rejects networks
    with error-severity findings (``AnalysisError``, a ``GraphError``),
    "warn" collects findings in ``meta["diagnostics"]`` without rejecting,
    False skips the analysis passes.

    ``megastep`` sets how many repetition-vector iterations one device
    launch covers ("auto"/int/False — see ``resolve_megastep``): crossing
    FIFO depths are sized for it here and the device backend reads the
    resolved target from ``meta["megastep"]``.
    """
    ctx = PassContext(
        graph=_as_graph(src),
        xcf=xcf,
        default_depth=default_depth,
        block=block,
        fuse=fuse,
        opt_level=opt_level,
        check=check,
        megastep=megastep,
    )
    return default_pipeline().run(ctx)


def legalize_xcf(graph: ActorGraph, xcf: XCF) -> IRModule:
    """Placement legalization only (no depth/fusion work) — what the
    partitioner runs over every candidate XCF before emitting it."""
    ctx = PassContext(graph=graph, xcf=xcf)
    return PassPipeline(
        [LowerFrontend(), LegalizePlacement()], record=False
    ).run(ctx)
