"""Device partition code generation (the paper's hardware backend, §III-B),
in eager PyTorch.

A device partition is the hw region of a *lowered IR module*
(``repro_torch.ir.lower``) compiled into ONE step function over tensors on
the partition's ``torch.device``.  By the time this backend runs, the
middle-end has already legalized the placement, resolved FIFO depths, and
(by default) fused every static-rate (SDF) sub-region into a single fused
actor — so the step invokes one ``vector_fire`` per *region*, not one per
authored actor, and the fused regions launch the CUDA kernel generated for
their stream program (``repro_torch.kernels.stream_fused``; built when the
partition is compiled) on the card, or run its plain PyTorch version on the
CPU.

Execution model: the partition step processes a *block* of tokens per
invocation.  Dynamic-rate actors (e.g. Filter) emit a validity mask; tokens
flow between in-partition actors as (values, mask) pairs.  The step also
returns an ``idle`` flag — hardware idleness detection (§III-B) — as a
device tensor: nothing on the launch path reads it back.

Megasteps: ``megastep`` runs ``megastep_k`` blocks ("chunks") per launch so
the host↔device boundary cost is paid once per k repetition-vector
iterations.  Inputs arrive as ``(k, block)`` stacks; on the generic path a
Python loop threads the chunks through ``step`` in order (the same ops as k
separate launches), and when every member is a fused CUDA stream region the
whole stack runs as ONE kernel launch over ``k*block`` tokens
(``flat_megastep`` — the kernel's token axis is shape-polymorphic and its
block transforms never straddle a chunk edge).  Actor state tensors stay on
the device, chained launch to launch.

Batched lanes (StreamServe): ``batched_step``/``batched_megastep`` step B
independent session lanes in one call, lane *i* bitwise the unbatched
``step``/``megastep`` over lane *i*.  Each fused CUDA stream region (no
state, ``block`` a multiple of its program's block unit) takes the B lanes'
wires as one ``(B*k, block)`` stack, so its kernel launches ONCE for the
round, as the reference's vmap makes one Pallas launch of B lanes; every
other member (unfused per-actor ``vector_fire``s, stateful scans: plain
torch ops, no kernel) steps the lanes one after another.  ``lane_flat``
marks a partition whose members are all such regions.

``region_quantum``, ``staging_plan``, ``_lower_legacy`` and
``resolve_megastep_k`` are copies of ``repro/runtime/device_runtime.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.actor import Actor
from repro_torch.core.graph import ActorGraph, GraphError
from repro_torch.ir.ir import IRModule


@dataclass
class DeviceProgram:
    """Compiled device partition."""

    name: str
    actors: List[str]
    in_ports: List[Tuple[str, str, str]]  # (actor, port, dtype)
    out_ports: List[Tuple[str, str, str]]
    step: Callable  # (state, {in: (vals, mask)}) -> (state, {out: (vals, mask)}, idle)
    init_state: Dict[str, Any]
    block: int
    fused: Dict[str, Tuple[str, ...]] = None  # fused actor -> member names
    # staging plan: boundary in-ports grouped by internal component, and the
    # token granule each port must be staged in (see ``staging_plan``)
    in_groups: Dict[str, List[str]] = field(default_factory=dict)
    in_quanta: Dict[str, int] = field(default_factory=dict)
    # which XCF partition this program implements, its declared processing
    # element, and the torch device it is bound to
    partition: str = ""
    pe: str = ""
    device: torch.device = None
    # megastep: chunks (repetition-vector blocks) per launch.  k == 1 means
    # the classic one-block step; k > 1 means ``megastep`` takes ``(k,
    # block)`` input stacks and returns ``(k, block)`` outputs.
    megastep_k: int = 1
    megastep: Callable = None
    # True when every member is a fused CUDA stream region (stateless, block
    # a multiple of its block unit): its wires may stack any number of
    # chunks or lanes into one launch of each region's kernel
    lane_flat: bool = False
    # B lanes of (block,) or (k, block) wires in one call (``batched_step``)
    batched: Callable = None

    @property
    def flat_megastep(self) -> bool:
        """True when the megastep is ONE flat (k*block)-token kernel launch
        instead of a k-chunk loop."""
        return self.lane_flat and self.megastep_k > 1

    def launch(self, state, inputs):
        """Dispatch one launch: the megastep when this program has one
        (``megastep_k > 1`` — inputs are ``(k, block)`` stacks), else the
        classic one-block ``step``."""
        if self.megastep_k > 1:
            return self.megastep(state, inputs)
        return self.step(state, inputs)

    def batched_step(self, batch: int) -> Callable:
        """One call stepping ``batch`` independent session lanes.

        Signature mirrors ``step`` with a leading lane axis everywhere:
        ``(state (B,...), {in: (vals (B,block), mask (B,block))}) ->
        (state', {out: (B,block)...}, idle (B,))``.  Lane *i* is bitwise an
        unbatched ``step`` over lane *i*'s state and block.  Each fused CUDA
        stream region launches its kernel once for the round, over
        ``B*block`` tokens; the other members step the lanes in turn.  One
        callable serves every batch size."""
        return self.batched

    def batched_megastep(self, batch: int) -> Callable:
        """``batched_step`` for megastep programs: ``batch`` lanes of
        ``(k, block)`` chunk stacks, lane *i* bitwise an unbatched
        ``megastep`` over lane *i*."""
        assert self.megastep is not None, (
            f"{self.name}: program compiled without a megastep"
        )
        return self.batched

    def batched_init_state(self, batch: int) -> Dict[str, Any]:
        """``init_state`` broadcast to ``batch`` lanes."""
        return _tree_map(
            lambda x: x.expand((batch,) + tuple(x.shape)), self.init_state
        )

    def pack_lanes(
        self, payloads: Sequence[Dict[str, Tuple[np.ndarray, np.ndarray]]],
    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Per-lane staged payloads -> one batched input dict on the device.

        Each payload maps ``"actor.port" -> (vals, mask)`` host arrays of
        shape ``(block,)`` (or ``(k, block)`` for megastep programs); the
        result stacks them along a new leading lane axis (lane *i* is
        ``payloads[i]``), in each port's staging dtype.  On CUDA the stack
        is written into pinned host memory and copied to the device
        asynchronously, as PLink stages (the caching host allocator keeps a
        pinned block until the copy that reads it has completed)."""
        from repro_torch.runtime.plink import _host_dtype

        cuda = self.device.type == "cuda"
        packed = {}
        for (a, p, dt) in self.in_ports:
            key = f"{a}.{p}"
            pair = []
            for j, dtype in ((0, _host_dtype(dt)), (1, torch.bool)):
                rows = [pay[key][j] for pay in payloads]
                shape = (len(rows),) + tuple(np.shape(rows[0]))
                host = torch.empty(shape, dtype=dtype, pin_memory=cuda)
                if dtype == torch.bfloat16:  # numpy has no bfloat16
                    host.copy_(torch.from_numpy(np.stack(rows).astype(np.float32)))
                else:
                    np.stack(rows, out=host.numpy())
                pair.append(host.to(self.device, non_blocking=True) if cuda else host)
            packed[key] = tuple(pair)
        return packed

    def stack_states(self, states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Per-session state trees -> one batched tree (lane order kept)."""
        return _tree_stack(states, self.device)

    @staticmethod
    def unstack_state(batched: Dict[str, Any], lane: int) -> Dict[str, Any]:
        """Extract one session's state tree from a batched tree."""
        return _tree_map(lambda x: x[lane], batched)


def region_quantum(module: IRModule, actor_name: str) -> int:
    """Token granularity one boundary port of ``actor_name`` must be staged
    in so no member op ever sees a torn block.

    A fused region's boundary port inherits its member's per-firing rate
    (often 1), but members *inside* the region may fire at coarser rates —
    the 8-point IDCT consumes 8 tokens per firing behind a rate-1 descale.
    Staging a block that is not a whole number of region iterations would
    hand such a member a block mixing valid tokens with padding.  The
    analyzer's region-restricted repetition vector gives the iteration
    shape: member ``m`` fires ``q[m]`` times, moving ``rate * q[m]`` tokens
    per port — the lcm of those per-iteration throughputs is the granule.
    """
    import math

    from repro_torch.analysis.rates import member_rates, region_repetition

    ir = module.actors[actor_name]
    members = list(ir.fused_from or (actor_name,))
    q = region_repetition(module, members)
    rate_of, _edges = member_rates(module, members)
    counts: List[int] = []
    for m in members:
        r = rate_of(m)
        for _p, n in tuple(r.consumes) + tuple(r.produces):
            if n > 0:
                counts.append(n * q.get(m, 1))
    return math.lcm(*counts) if counts else 1


def staging_plan(
    module: IRModule,
    in_ports: Sequence[Tuple[str, str, str]],
    members: Optional[Sequence[str]] = None,
) -> Tuple[Dict[str, List[str]], Dict[str, int]]:
    """Group boundary in-ports and compute each port's staging granule —
    the shared plan behind PLink and the serve-mode DeviceStage.

    Ports are grouped by the *internal connected component* of the
    partition their destination belongs to, and a stager drains whole
    granules lane-aligned across a group.  Destination-actor grouping alone
    is not enough: two boundary streams that converge downstream *inside*
    the partition (e.g. a bitonic stage fed partly by a host deal lane and
    partly by another device partition's lane) must advance the same number
    of iterations per launch, or the internal wires pair tokens from
    different stream positions — internal wires are not buffered across
    launches.  Disjoint internal components keep independent progress, so a
    placement like {descale, clip} with the idct on the host between them
    still pipelines instead of deadlocking on the empty downstream group.

    Granules come from the analyzer's repetition vector, solved once per
    internal component over the *authored* members (fused actors expand to
    their ``fused_from``): port ``a.p`` stages ``consume_rate(p) *
    q[member]`` tokens per component iteration — the replacement for the
    old lcm-of-all-rates derivation, agreeing with it on every Table-I
    network but tighter on mixed-rate chains.
    """
    from repro_torch.analysis.rates import port_member, region_repetition
    from repro_torch.ir.ir import connected_components

    sub = set(members) if members is not None else {a for (a, _p, _d) in in_ports}
    comp = connected_components(sub, module.channels)
    comp_members: Dict[str, List[str]] = {}
    for a in sub:
        ir = module.actors[a]
        comp_members.setdefault(comp[a], []).extend(ir.fused_from or (a,))
    comp_q = {
        k: region_repetition(module, ms) for k, ms in comp_members.items()
    }

    groups: Dict[str, List[str]] = {}
    quanta: Dict[str, int] = {}
    for (a, p, _dt) in in_ports:
        key = f"{a}.{p}"
        groups.setdefault(comp[a], []).append(key)
        c = max(module.actors[a].rate.consume_rate(p), 1)
        q = comp_q[comp[a]].get(port_member(module, a, p), 1)
        quanta[key] = c * q
    return groups, quanta


def feeds_itself(
    channels: Sequence, members: Sequence[str]
) -> Optional[Tuple[str, str]]:
    """A pair ``(a, b)`` of ``members``, in one connected part of the
    partition, where a path leaves the partition at ``a`` and comes back in
    at ``b``; None when no part of the partition feeds itself.

    ``staging_plan`` stages a connected part's boundary ports in lockstep, so
    such a part waits for tokens that only its own next launch would make:
    the placement stalls (it does in the reference too).  ``explore()`` can
    emit one where device placements tie in the MILP.  ``channels`` are a
    graph's or a lowered module's (``src``/``dst`` actor names)."""
    from repro_torch.ir.ir import connected_components

    sub = set(members)
    part = connected_components(sub, channels)
    succ: Dict[str, set] = {}
    for ch in channels:
        succ.setdefault(ch.src, set()).add(ch.dst)
    for a in sorted(sub):
        seen, stack = set(), [v for v in succ.get(a, ()) if v not in sub]
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            for v in succ.get(x, ()):
                if v in sub and part[v] == part[a]:
                    return a, v
                stack.append(v)  # off the partition, or another part of it
    return None


def resolve_pe_device(pe: str, default) -> torch.device:
    """Map an XCF ``PartitionSpec.pe`` string to a ``torch.device``.

    ``"cuda"``/``"gpu"`` (optionally ``":<index>"``) select ``cuda:<index>``
    and ``"cpu"`` the CPU.  Every other string — accelerator-model names like
    ``"tpu-v5e-16x16"`` (the XCF default), host PEs, the empty string —
    binds to ``default``, the caller's device.
    """
    m = re.fullmatch(r"(cuda|gpu|cpu)(?::(\d+))?", (pe or "").lower())
    if m is None:
        return torch.device(default)
    if m.group(1) == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(m.group(2) or 0))


# JAX, whose 64-bit types are off by default, holds Python floats and ints
# (and 64-bit arrays) as 32-bit arrays on the device; the port keeps state
# leaves and staged channels in the same types.
NARROW_64 = {
    torch.float64: torch.float32, torch.int64: torch.int32,
    torch.uint64: torch.uint32,
}


def _leaf_to(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, bool):
        t = torch.tensor(x)
    elif isinstance(x, int):
        t = torch.tensor(x, dtype=torch.int32)
    elif isinstance(x, float):
        t = torch.tensor(x, dtype=torch.float32)
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=NARROW_64.get(t.dtype, t.dtype))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_stack(trees: Sequence, device: torch.device):
    """Stack matching leaves of ``trees`` along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(
            _tree_stack([t[i] for t in trees], device) for i in range(len(first))
        )
    return torch.stack([_leaf_to(x, device) for x in trees])


def state_from_numpy(program: DeviceProgram, tree) -> Dict[str, Any]:
    """A state tree of numpy arrays — e.g. a JAX ``DeviceProgram``'s state
    after ``jax.device_get`` — as the port's tensors on the program's device,
    ready to pass to ``program.step``."""
    return _tree_map(lambda x: _leaf_to(x, program.device), tree)


def state_to_numpy(program: DeviceProgram, state=None):
    """A port state tree (default: ``program.init_state``) as numpy arrays —
    the form a JAX ``DeviceProgram`` takes back after ``jax.device_put``."""
    if state is None:
        state = program.init_state
    return _tree_map(lambda t: t.detach().cpu().numpy(), state)


def default_vector_fire(actor: Actor):
    """Vectorize a 1-action SDF actor's scalar fire over a token block — a
    Python loop over the tokens, threading the state as ``lax.scan`` does in
    the reference (padding positions included)."""
    action = actor.actions[0]
    in_ports = [p.name for p in actor.inputs]
    out_ports = [p.name for p in actor.outputs]

    def vf(state, ins):  # ins: {port: (vals (N,), mask (N,))}
        assert ins, "sourceless actors need an explicit vector_fire"
        ref, mask = ins[in_ports[0]]
        cols: Dict[str, List] = {p: [] for p in out_ports}
        st = state
        for i in range(ref.shape[0]):
            st, outs = action.fire(st, {p: [ins[p][0][i]] for p in in_ports})
            for p in out_ports:
                v = outs[p][0]
                cols[p].append(v if isinstance(v, torch.Tensor) else _leaf_to(v, ref.device))
        return st, {p: (torch.stack(cols[p]), mask) for p in out_ports}

    return vf


def _lower_legacy(graph: ActorGraph, names: Sequence[str]) -> IRModule:
    """Lower a raw graph with ``names`` on the device partition, *without*
    fusion — the legacy ``compile_partition(graph, [...])`` contract exposes
    per-actor boundary ports, which fusion would rename."""
    from repro_torch.core.xcf import make_xcf
    from repro_torch.ir.passes import lower

    sub = set(names)
    assignment = {
        a: ("accel" if a in sub else "t0") for a in graph.actors
    }
    return lower(graph, make_xcf(graph.name, assignment), fuse=False)


def resolve_megastep_k(
    module: IRModule,
    sub,
    init_state: Dict[str, Any],
    in_ports,
    block: int,
    megastep,
) -> int:
    """Clamp the requested megastep target to what one partition supports.

    A launch of k chunks stages up to ``k*block`` tokens per boundary port
    and may retire as many, and PLink keeps a second launch in flight while
    the first computes — every crossing FIFO must absorb ``2*k*block``
    tokens, so k is floored to ``depth // (2*block)`` over the partition's
    boundary channels (depth inference sizes them for the requested k; an
    XCF-pinned shallower depth clamps here, flagged by the SB206 lint).
    Stateful partitions are clamped to 1: the block scan that vectorizes a
    stateful actor advances its state over *padding* positions too, so only
    all-stateless partitions (fused stream regions, stateless vector fires)
    keep megastep ≡ per-iteration bitwise on ragged tails.  Partitions with
    no boundary inputs (on-device sources) have no staged work to amortize
    and also stay at 1.
    """
    from repro_torch.ir.passes import resolve_megastep

    if megastep is None:
        megastep = module.meta.get("megastep", 1)
    k = resolve_megastep(megastep)
    if k <= 1:
        return 1
    if not in_ports:
        return 1
    if any(s for s in init_state.values()):
        return 1
    for ch in module.channels:
        if (ch.src in sub) == (ch.dst in sub):
            continue
        depth = ch.resolved_depth
        if depth:
            k = min(k, max(1, depth // (2 * block)))
    return max(1, k)


def compile_partition(
    src,
    actor_names: Optional[Sequence[str]] = None,
    *,
    block: int = 1024,
    name: str = "accel",
    partition: Optional[str] = None,
    device: Any = None,
    megastep=None,
) -> DeviceProgram:
    """Compile one hw region of ``src`` into one step over torch tensors.

    ``src`` is a lowered ``IRModule`` (the supported path — fusion and depth
    inference already applied) or a raw ``ActorGraph`` plus ``actor_names``
    (legacy path: lowered on the spot, unfused, per-actor boundary ports).
    ``partition`` selects a region by id when the module has several hw
    regions.  ``device`` is the caller's device (default ``cuda:0``); the
    region's ``pe`` string may name another (``resolve_pe_device``).
    ``megastep`` overrides the lowered module's ``meta["megastep"]``
    chunks-per-launch target; either way the effective ``megastep_k`` is
    clamped per partition (``resolve_megastep_k``).
    """
    pe = ""
    if isinstance(src, IRModule):
        module = src
        if partition is not None:
            region = module.regions.get(partition)
            if region is None or region.kind != "hw":
                raise GraphError(
                    f"{module.name}: no hw partition {partition!r} (hw "
                    f"partitions: {[r.id for r in module.hw_regions()]})"
                )
            actor_names = region.actors
            name = region.id
            pe = region.pe
        elif actor_names is None:
            hws = module.hw_regions()
            assert hws, f"{module.name}: module has no hw region"
            assert len(hws) == 1, (
                f"{module.name}: {len(hws)} hw regions "
                f"({[r.id for r in hws]}); pass partition= (or use "
                f"compile_hw_partitions) to pick one"
            )
            actor_names = hws[0].actors
            name = hws[0].id
            pe = hws[0].pe
        names = sorted(actor_names)
    else:
        assert actor_names is not None, "compile_partition(graph, names)"
        names = list(actor_names)
        for a in names:
            actor = src.actors[a]
            assert actor.device_ok, (
                f"{a}: {actor.host_only_reason or 'host-only actor'}"
            )
        module = _lower_legacy(src, names)
        names = sorted(names)
    sub = set(names)
    device = resolve_pe_device(pe, "cuda:0" if device is None else device)

    # boundary ports (post-fusion names — what PLink stages against)
    in_ports, out_ports = [], []
    internal: List = []
    for ch in module.channels:
        if ch.dst in sub and ch.src not in sub:
            in_ports.append((ch.dst, ch.dst_port, ch.dtype))
        elif ch.src in sub and ch.dst not in sub:
            out_ports.append((ch.src, ch.src_port, ch.dtype))
        elif ch.src in sub and ch.dst in sub:
            internal.append(ch)

    # topological order of the partition's actors (feedback not supported on device)
    order = [a for a in module.topo_order() if a in sub]

    impls = {a: module.actors[a].impl for a in names}
    if device.type == "cuda":
        # each fused region's generated kernel is built (or loaded) here,
        # off the clock of every run; a failed build raises
        from repro_torch.kernels.stream_fused.kernel import compile_program

        for a in names:
            prog_obj = getattr(impls[a], "stream_program", None)
            if module.actors[a].codegen == "cuda" and prog_obj is not None:
                compile_program(prog_obj, device)
    vfs = {
        a: (impls[a].vector_fire or default_vector_fire(impls[a]))
        for a in names
    }
    init_state = {
        a: _tree_map(lambda x: _leaf_to(x, device), dict(impls[a].initial_state))
        for a in names
    }
    actor_in_ports = {a: [p.name for p in impls[a].inputs] for a in names}

    def members(state, inputs, fire):
        """Fire the members in topological order, routing their wires:
        ``fire(a, state[a], {port: (vals, mask)}) -> (state', outs)``."""
        wires: Dict[Tuple[str, str], Tuple[torch.Tensor, torch.Tensor]] = {}
        for (a, p, _dt) in in_ports:
            wires[(a, p)] = inputs[f"{a}.{p}"]
        new_state = dict(state)
        outs: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for a in order:
            ins = {p: wires[(a, p)] for p in actor_in_ports[a]}
            st, a_outs = fire(a, new_state[a], ins)
            new_state[a] = st
            for ch in internal:
                if ch.src == a:
                    wires[(ch.dst, ch.dst_port)] = a_outs[ch.src_port]
            for (sa, sp, _dt) in out_ports:
                if sa == a:
                    outs[f"{sa}.{sp}"] = a_outs[sp]
        return new_state, outs

    def step(state, inputs):
        """inputs: {"actor.port": (vals, mask)}, each (block,) or (k, block)"""
        new_state, outs = members(state, inputs, lambda a, st, ins: vfs[a](st, ins))
        # idle <=> no valid token consumed or produced; stays on the device
        masks = [m.reshape(-1) for _, m in outs.values()]
        masks += [m.reshape(-1) for _, m in inputs.values()]
        if masks:
            idle = torch.logical_not(torch.cat(masks).any())
        else:
            idle = torch.ones((), dtype=torch.bool, device=device)
        return new_state, outs, idle

    in_groups, in_quanta = staging_plan(module, in_ports, names)
    too_small = {k: q for k, q in in_quanta.items() if q > block}
    if too_small:
        raise GraphError(
            f"{name}: block={block} is smaller than the staging quantum of "
            f"{too_small} — a whole region iteration must fit in one staged "
            f"block; raise block= to at least the largest quantum"
        )

    megastep_k = resolve_megastep_k(
        module, sub, init_state, in_ports, block, megastep
    )
    # Flat members: a fused CUDA stream region is shape-polymorphic over the
    # token axis (its kernel takes a (k, block) stack, or B lanes of them,
    # in one launch, each row as it would be alone) — provided it holds no
    # state and no block transform (matmul8 8-blocks, perm P-blocks)
    # straddles a chunk edge, i.e. block % block_unit == 0.
    from repro_torch.kernels.stream_fused.ops import block_unit

    def _flat_ok(a: str) -> bool:
        prog_obj = getattr(impls[a], "stream_program", None)
        return (
            module.actors[a].codegen == "cuda"
            and prog_obj is not None
            and not init_state[a]
            and block % block_unit(prog_obj) == 0
        )

    flat_members = {a for a in names if _flat_ok(a)}
    lane_flat = flat_members == sub

    def batched(state, inputs):
        """B lanes of (B, block) or (B, k, block) wires: a flat member runs
        the lanes' (and chunks') rows as one (B*k, block) stack — one launch
        of its kernel — and every other member steps each lane's chunks in
        order, threading that lane's state, as the unbatched
        ``step``/``megastep`` does."""
        lead = next(iter(inputs.values()))[0].shape[:-1]

        def fire(a, st_b, ins):
            if a in flat_members:
                rows = {p: (v.reshape(-1, block), m.reshape(-1, block))
                        for p, (v, m) in ins.items()}
                _st, outs = vfs[a](st_b, rows)
                return st_b, {
                    p: (v.reshape(lead + v.shape[-1:]), m.reshape(lead + m.shape[-1:]))
                    for p, (v, m) in outs.items()
                }
            lane_states, cols = [], {}
            for i in range(lead[0]):
                st = DeviceProgram.unstack_state(st_b, i)
                for at in [(i, j) for j in range(lead[1])] if len(lead) > 1 else [(i,)]:
                    st, outs = vfs[a](st, {p: (v[at], m[at]) for p, (v, m) in ins.items()})
                    for p, pair in outs.items():
                        cols.setdefault(p, []).append(pair)
                lane_states.append(st)
            return _tree_stack(lane_states, device), {
                p: tuple(
                    torch.stack([pair[x] for pair in pairs]).reshape(lead + pairs[0][x].shape)
                    for x in (0, 1)
                )
                for p, pairs in cols.items()
            }

        new_state, outs = members(state, inputs, fire)
        masks = [m.reshape(lead[0], -1) for _, m in outs.values()]
        masks += [m.reshape(lead[0], -1) for _, m in inputs.values()]
        idle = torch.logical_not(torch.cat(masks, dim=1).any(dim=1))
        return new_state, outs, idle

    megastep_fn = None
    if megastep_k > 1:
        if lane_flat:
            megastep_fn = step
        else:
            def megastep_fn(state, inputs):
                """``step`` over the k chunks in order — the same ops as k
                sequential launches, with the boundary paid once."""
                chunk_outs, idles = [], []
                for j in range(megastep_k):
                    chunk = {key: (v[j], m[j]) for key, (v, m) in inputs.items()}
                    state, outs, idle = step(state, chunk)
                    chunk_outs.append(outs)
                    idles.append(idle)
                outs = {
                    key: (
                        torch.stack([o[key][0] for o in chunk_outs]),
                        torch.stack([o[key][1] for o in chunk_outs]),
                    )
                    for key in chunk_outs[0]
                }
                return state, outs, torch.stack(idles).all()

    return DeviceProgram(
        name=name,
        actors=names,
        in_ports=in_ports,
        out_ports=out_ports,
        in_groups=in_groups,
        in_quanta=in_quanta,
        step=step,
        init_state=init_state,
        block=block,
        fused={
            a: module.actors[a].fused_from
            for a in names
            if module.actors[a].is_fused
        },
        partition=partition or name,
        pe=pe,
        device=device,
        megastep_k=megastep_k,
        megastep=megastep_fn,
        lane_flat=lane_flat,
        batched=batched,
    )


def compile_hw_partitions(
    module: IRModule,
    *,
    block: int = 1024,
    device: Any = None,
    megastep=None,
) -> Dict[str, "DeviceProgram"]:
    """Compile every hw region of a lowered module — one ``DeviceProgram``
    per device partition, each bound to the device its ``PartitionSpec.pe``
    resolves to (``device`` is the caller's default).  Returns ``{partition
    id: program}`` in stable order.  ``megastep`` defaults to the module's
    lowered ``meta["megastep"]`` target."""
    return {
        r.id: compile_partition(
            module, block=block, partition=r.id, device=device,
            megastep=megastep,
        )
        for r in module.hw_regions()
        if r.actors  # an empty hw partition has nothing to compile
    }
