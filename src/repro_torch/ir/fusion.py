"""SDF region fusion: collapse a static-rate subgraph of a device partition
into one fused actor with a single ``vector_fire``.

Two codegen strategies, picked per region:

  * **stream** ("cuda") — every member carries a declarative ``stream_op``
    spec (``("affine", pre, mul, post)``, ``("mac", c)``, ``("cmpx", asc)``,
    ``("matmul8", basis)``, ...).  The region compiles to a
    ``StreamProgram`` — a static op list over token-wire registers —
    dispatched through ``repro_torch.kernels.stream_fused`` (the CUDA kernel
    for CUDA tensors, its plain PyTorch version for CPU tensors).  Op
    expressions mirror the member ``vector_fire``s bit-for-bit in float32,
    so fusion is equivalence-tested exactly against the unfused path.
  * **composed** ("torch") — fallback when specs are missing: member
    ``vector_fire``s are evaluated in topological order inside one
    function.  Still one device actor (one wire map, one state tree) instead
    of N.

Masks never change inside an SDF region (rates are static, guards absent),
so each fused output's validity mask is *selected* from the fused inputs at
build time — the runtime moves only values.

Port of ``repro/ir/fusion.py``: ``build_fused`` bakes the port's
``fused_stream`` into the fused actor, and the codegen tags are ``"cuda"`` /
``"torch"`` where the reference has ``"pallas"`` / ``"jnp"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.actor import Action, Actor, Port
from repro_torch.core.graph import GraphError
from repro_torch.kernels.stream_fused import StreamOp, StreamProgram, fold, fused_stream


@dataclass
class FusedBuild:
    """Everything the pass needs to splice a fused actor into the module."""

    actor: Actor                       # synthetic impl (vector_fire only)
    codegen: str                       # "cuda" | "torch"
    in_port_of: Dict[Tuple[str, str], str]   # (member, port) -> fused port
    out_port_of: Dict[Tuple[str, str], str]
    members: Tuple[str, ...]
    program: Optional[StreamProgram] = None


def _fused_port(actor: str, port: str) -> str:
    return f"{actor}__{port}"


def _region_io(module, members: Sequence[str]):
    """Boundary input/output endpoints and internal channels of the region."""
    sub = set(members)
    ins, outs, internal = [], [], []
    for ch in module.channels:
        if ch.dst in sub and ch.src not in sub:
            ins.append(ch)
        elif ch.src in sub and ch.dst not in sub:
            outs.append(ch)
        elif ch.src in sub and ch.dst in sub:
            internal.append(ch)
    return ins, outs, internal


# ---------------------------------------------------------------------------
# Stream-program codegen (the CUDA kernel path)
# ---------------------------------------------------------------------------


def _translate_spec(spec, in_reg, new_reg, emit):
    """Lower one actor's ``stream_op`` spec to ops.

    Returns ``{out_port: (value_reg, mask_reg)}`` or None when the spec kind
    is unknown (the whole region then falls back to composed codegen).
    ``in_reg(port) -> (reg, mask_reg)``; masks are propagated exactly the way
    the member's ``vector_fire`` propagates them.
    """
    kind = spec[0]
    if kind == "affine":
        pre, mul, post = (float(x) for x in spec[1:])
        x, m = in_reg("IN")
        o = new_reg()
        emit(StreamOp("affine", (x,), o, (pre, mul, post)))
        return {"OUT": (o, m)}
    if kind == "clip":
        lo, hi = (float(x) for x in spec[1:])
        x, m = in_reg("IN")
        o = new_reg()
        emit(StreamOp("clip", (x,), o, (lo, hi)))
        return {"OUT": (o, m)}
    if kind == "matmul8":
        basis = np.asarray(spec[1], np.float32)
        x, m = in_reg("IN")
        o = new_reg()
        emit(StreamOp("matmul8", (x,), o, (basis,)))
        return {"OUT": (o, m)}
    if kind == "mac":
        c = float(spec[1])
        x, xm = in_reg("XIN")
        a, am = in_reg("AIN")
        o = new_reg()
        emit(StreamOp("axpy", (x, a), o, (c,)))
        return {"XOUT": (x, xm), "AOUT": (o, am)}
    if kind == "fir_seed":
        x, m = in_reg("IN")
        z = new_reg()
        emit(StreamOp("const", (x,), z, (0.0,)))
        return {"XOUT": (x, m), "AOUT": (z, m)}
    if kind == "cmpx":
        ascending = bool(spec[1])
        a, am = in_reg("IN0")
        b, bm = in_reg("IN1")
        lo, hi = new_reg(), new_reg()
        emit(StreamOp("min2", (a, b), lo))
        emit(StreamOp("max2", (a, b), hi))
        if ascending:
            return {"OUT0": (lo, am), "OUT1": (hi, bm)}
        return {"OUT0": (hi, am), "OUT1": (lo, bm)}
    if kind == "dup":
        x, m = in_reg("IN")
        n = int(spec[1])
        return {f"O{i}": (x, m) for i in range(n)}
    if kind == "perm":
        idx = np.asarray(spec[1], np.int32)
        x, m = in_reg("IN")
        o = new_reg()
        emit(StreamOp("perm", (x,), o, (idx,)))
        return {"OUT": (o, m)}
    return None


def _try_stream_program(
    module, order: Sequence[str], b_ins, b_outs, internal, *, opt_level: int,
):
    """Build a StreamProgram for the region (members in topological
    ``order``), or None if any member lacks a recognizable spec / has state /
    isn't float32."""
    for m in order:
        impl = module.actors[m].impl
        if impl.stream_op is None or impl.initial_state:
            return None
        if any(p.dtype != "float32" for p in impl.inputs + impl.outputs):
            return None

    n_regs = len(b_ins)
    ops: List[StreamOp] = []
    # (member, in_port) -> (value reg, mask source: fused input port name)
    wire: Dict[Tuple[str, str], Tuple[int, str]] = {}
    for i, ch in enumerate(b_ins):
        wire[(ch.dst, ch.dst_port)] = (i, _fused_port(ch.dst, ch.dst_port))

    def new_reg() -> int:
        nonlocal n_regs
        n_regs += 1
        return n_regs - 1

    for m in order:
        spec = module.actors[m].impl.stream_op

        def in_reg(port: str, _m=m):
            try:
                return wire[(_m, port)]
            except KeyError:
                raise GraphError(
                    f"fusion: {_m}.{port} has no producer inside or outside "
                    f"the region"
                ) from None

        produced = _translate_spec(spec, in_reg, new_reg, ops.append)
        if produced is None:
            return None
        for ch in internal:
            if ch.src == m:
                wire[(ch.dst, ch.dst_port)] = produced[ch.src_port]
        for ch in b_outs:
            if ch.src == m:
                wire[(m, "__out__" + ch.src_port)] = produced[ch.src_port]

    out_regs, out_masks = [], []
    for ch in b_outs:
        reg, mask = wire[(ch.src, "__out__" + ch.src_port)]
        out_regs.append(reg)
        out_masks.append(mask)
    prog = StreamProgram(len(b_ins), n_regs, tuple(ops), tuple(out_regs))
    if opt_level >= 2:
        prog = fold(prog)
    return prog, out_masks


# ---------------------------------------------------------------------------
# Host-region codegen (fused block execution of static-rate *software* regions)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HostFusedSpec:
    """Codegen product of ``fuse-sdf-host-regions`` (see ``passes.py``).

    Unlike device fusion, host fusion rewrites *nothing*: the members stay in
    the module, their channels keep their keys, and this spec just tells the
    runtimes how to drive the region as one block executor
    (``repro_torch.runtime.host_fused.HostFusedRegion``) — bulk-reading the
    boundary channels listed here, evaluating ``program`` with the numpy
    float64 evaluator (``kernels.stream_fused.fused_stream_np``), and
    bulk-writing the outputs.  Keeping the members intact is what makes the
    per-token interpreted fallback (dynamic tails, blocked outputs) free.
    """

    members: Tuple[str, ...]                      # topological order
    program: StreamProgram
    in_keys: Tuple[Tuple[str, str, str, str], ...]   # program input order
    out_keys: Tuple[Tuple[str, str, str, str], ...]  # program output order
    internal_keys: Tuple[Tuple[str, str, str, str], ...]
    quantum: int            # tokens per whole region iteration (lcm of rates)
    fires_each: Tuple[int, ...]  # per-member firings per iteration (repetition
    #                              vector entries, aligned with ``members``)
    fires_per_quantum: int  # interpreted member firings one quantum replaces
    block: int              # max tokens per fused invocation

    def __repr__(self) -> str:  # keep ir_dump meta lines readable
        return (
            f"HostFusedSpec({'+'.join(self.members)}, q={self.quantum}, "
            f"{len(self.program.ops)} ops)"
        )


def build_host_fused(
    module, members: Sequence[str], *, opt_level: int = 1, block: int = 1024
) -> Optional[HostFusedSpec]:
    """Lower one static-rate software region to a ``HostFusedSpec``, or None
    when any member falls outside the stream-op palette (the region then
    stays fully interpreted)."""
    from repro_torch.analysis.rates import region_repetition

    order = [a for a in module.topo_order() if a in set(members)]
    b_ins, b_outs, internal = _region_io(module, order)
    try:
        built = _try_stream_program(
            module, order, b_ins, b_outs, internal, opt_level=opt_level
        )
    except GraphError:  # e.g. a feedback edge inside the group
        return None
    if built is None:
        return None
    program, _masks = built
    # The analyzer's region-restricted repetition vector is the single
    # source of truth for iteration shape: member m fires q[m] times per
    # region iteration, and every boundary channel moves rate*q[endpoint]
    # tokens.  The block executor drives all boundary fifos with one scalar
    # quantum, so those per-channel counts must agree — true across the 1:1
    # stream-op palette; anything else stays interpreted.
    q = region_repetition(module, order)
    fires_each = [q[m] for m in order]
    counts = set()
    for ch in b_ins:
        counts.add(
            module.actors[ch.dst].rate.consume_rate(ch.dst_port) * q[ch.dst]
        )
    for ch in b_outs:
        counts.add(
            module.actors[ch.src].rate.produce_rate(ch.src_port) * q[ch.src]
        )
    if len(counts) != 1 or 0 in counts:
        return None
    quantum = counts.pop()
    fires = sum(fires_each)
    return HostFusedSpec(
        members=tuple(order),
        program=program,
        in_keys=tuple(ch.key for ch in b_ins),
        out_keys=tuple(ch.key for ch in b_outs),
        internal_keys=tuple(ch.key for ch in internal),
        quantum=quantum,
        fires_each=tuple(fires_each),
        fires_per_quantum=fires,
        block=max(block, quantum),
    )


# ---------------------------------------------------------------------------
# Composed-vector_fire codegen (the torch fallback)
# ---------------------------------------------------------------------------


def _member_vf(impl: Actor) -> Callable:
    if impl.vector_fire is not None:
        return impl.vector_fire
    from repro_torch.runtime.device_runtime import default_vector_fire

    return default_vector_fire(impl)


def _composed_vf(module, order, b_ins, b_outs, internal):
    """One function evaluating the whole region member-by-member — the exact
    computation the unfused device step performs, minus the per-actor
    partition plumbing.  Endpoint names are snapshotted eagerly: the fusion
    pass rewrites the boundary IRChannel objects to the fused actor's name
    right after this closure is built."""
    vfs = {m: _member_vf(module.actors[m].impl) for m in order}
    in_ports = {m: [p.name for p in module.actors[m].impl.inputs] for m in order}
    in_map = [
        ((ch.dst, ch.dst_port), _fused_port(ch.dst, ch.dst_port))
        for ch in b_ins
    ]
    out_map = [
        ((ch.src, ch.src_port), _fused_port(ch.src, ch.src_port))
        for ch in b_outs
    ]
    wiring = [(ch.src, ch.src_port, ch.dst, ch.dst_port) for ch in internal]

    def vf(state, ins):
        wires = {ep: ins[fp] for ep, fp in in_map}
        new_state = dict(state)
        outs = {}
        for m in order:
            m_ins = {p: wires[(m, p)] for p in in_ports[m]}
            st, m_outs = vfs[m](new_state[m], m_ins)
            new_state[m] = st
            for (s, sp, d, dp) in wiring:
                if s == m:
                    wires[(d, dp)] = m_outs[sp]
            for (s, sp), fp in out_map:
                if s == m:
                    outs[fp] = m_outs[sp]
        return new_state, outs

    return vf


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def build_fused(
    module, members: Sequence[str], name: str, *, opt_level: int = 1
) -> FusedBuild:
    """Synthesize the fused actor for an SDF region of ``module``."""
    order = [a for a in module.topo_order() if a in set(members)]
    b_ins, b_outs, internal = _region_io(module, order)

    in_ports = [
        Port(_fused_port(ch.dst, ch.dst_port),
             module.actors[ch.dst].port(ch.dst_port).dtype)
        for ch in b_ins
    ]
    out_ports = [
        Port(_fused_port(ch.src, ch.src_port),
             module.actors[ch.src].port(ch.src_port).dtype)
        for ch in b_outs
    ]
    in_names = [p.name for p in in_ports]
    out_names = [p.name for p in out_ports]

    built = _try_stream_program(
        module, order, b_ins, b_outs, internal, opt_level=opt_level
    )
    if built is not None:
        program, out_masks = built

        def vf(state, ins, _prog=program, _masks=tuple(out_masks)):
            vals = fused_stream([ins[p][0] for p in in_names], _prog)
            return state, {
                o: (v, ins[m][1]) for o, v, m in zip(out_names, vals, _masks)
            }

        codegen = "cuda"
        init_state: Dict = {}
    else:
        program = None
        vf = _composed_vf(module, order, b_ins, b_outs, internal)
        codegen = "torch"
        init_state = {
            m: dict(module.actors[m].impl.initial_state) for m in order
        }

    # Boundary rates: each fused port keeps its member's per-firing rate.
    consumes = {
        _fused_port(ch.dst, ch.dst_port):
            module.actors[ch.dst].rate.consume_rate(ch.dst_port)
        for ch in b_ins
    }
    produces = {
        _fused_port(ch.src, ch.src_port):
            module.actors[ch.src].rate.produce_rate(ch.src_port)
        for ch in b_outs
    }

    def no_scalar_fire(st, t):  # pragma: no cover - fused regions are hw-only
        raise NotImplementedError(
            f"fused region {name} executes on the device partition only"
        )

    actor = Actor(
        name=name,
        inputs=in_ports,
        outputs=out_ports,
        actions=[
            Action("fused", consumes=consumes, produces=produces,
                   fire=no_scalar_fire)
        ],
        initial_state=init_state,
        device_ok=True,
        vector_fire=vf,
    )
    if codegen == "cuda":
        # expose the StreamProgram on the actor impl: the device runtime's
        # flat-megastep gate reads it to size (k, block) chunk stacks against
        # the program's block_unit
        actor.stream_program = program
    return FusedBuild(
        actor=actor,
        codegen=codegen,
        in_port_of={(ch.dst, ch.dst_port): _fused_port(ch.dst, ch.dst_port)
                    for ch in b_ins},
        out_port_of={(ch.src, ch.src_port): _fused_port(ch.src, ch.src_port)
                     for ch in b_outs},
        members=tuple(order),
        program=program,
    )
