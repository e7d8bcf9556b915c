"""Logical-axis sharding over a ``torch.distributed`` ``DeviceMesh`` (port of
``repro/distributed/sharding.py``).

Model code annotates activations and parameters with *logical* axis names;
this module maps them onto mesh axes with the reference's divisibility
fallback (a dim that does not divide is replicated).  ``BASE_RULES``,
``make_rules``, ``full_dp_rules``, ``_resolve`` and ``make_pspec`` are the
reference's, pinned by ``tests/test_torch_copies.py`` (edit: ``_resolve``
reads the mesh's axis names through :func:`axis_names`, since a
``DeviceMesh`` calls them ``mesh_dim_names``).  A :class:`PartitionSpec` is
a tuple of entries, each ``None``, a mesh axis name or a tuple of them.

DTensor is the port's GSPMD: the function computed is the one computed on
one device.  :func:`to_placements` turns a spec into DTensor placements (one
per mesh dim: ``Shard(d)`` where tensor dim ``d`` names that axis, else
``Replicate()``); :func:`constrain` is a ``redistribute`` to the placements
the rules give.  It is the identity without a context, and it raises on a
plain tensor inside one: a plain tensor in a sharded step has left the mesh.
Tensors the model creates inside the step (positions, masks, iotas) enter the
mesh through :func:`replicate`.

:func:`local_call` is the boundary around a kernel (``kernels/*/ops.py``) or
an op with no sharding rule: it runs a function of plain tensors on each
rank's shards (``torch.distributed.tensor.experimental.local_map`` with
``redistribute_inputs=True``), with the input placements the function can
take locally and the placements of its outputs; an input replicated on a
mesh dim along which the others are split gets a partial gradient there.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import AbstractMesh
from repro_torch.paramdef import is_paramdef
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

Rules = Dict[str, Any]  # logical axis -> mesh axis | tuple of mesh axes | None
Mesh = Union[DeviceMesh, AbstractMesh]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (the dim split over those axes, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A ``(mesh, placements)`` pair: where one leaf lies."""

    mesh: DeviceMesh
    placements: Tuple[Placement, ...]


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


# Storage/default rules, independent of architecture.
BASE_RULES: Rules = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "tp": "model",
    "vocab": "model",
    "layers": None,
    "seq": "model",        # activation sequence dim between blocks (Megatron-SP)
    "seq_full": None,      # sequence dim inside a block after gathering
    "ff": "model",
    "experts": "model",
    "expert_cap": "data",  # MoE capacity dim of the dispatch buffer
    "kv_heads": "model",   # falls back to replicated when not divisible
    "kv_seq": None,        # decode-cache sequence dim (flash-decode sharding when
    #                        kv heads don't divide the model axis — see make_rules)
    "kv_batch": ("pod", "data"),
    # strategy-dependent (filled by make_rules):
    "heads": "model",
    "seq_q": None,
    "ssm_heads": "model",
    "ssm_hd": None,
    "ssm_state": None,
    # out-projection input placement (§Perf beyond-paper lever): None keeps the
    # Megatron row-parallel form (contraction sharded -> psum of the full-seq
    # output); "model" reshards the activation to sequence-sharded FIRST (an
    # a2a) and gathers the small weight instead — no output all-reduce.
    "ffn_act_seq": None,
    "attn_out_seq": None,
}


def make_rules(cfg, mesh: Mesh, overrides: Optional[Rules] = None) -> Rules:
    """Architecture-aware rules: pick attention / SSM parallel strategies."""
    rules = dict(BASE_RULES)
    msize = _axis_size(mesh, "model")
    if cfg.num_heads and msize > 1:
        if cfg.num_heads % msize == 0:
            rules["heads"] = "model"  # head tensor parallel (Megatron)
            rules["seq_q"] = None
        else:
            rules["heads"] = None  # context parallel: shard query sequence
            rules["seq_q"] = "model"
            rules["kv_heads"] = None
        # decode cache: shard kv heads when they divide, else the cache sequence
        # (flash-decode: softmax over the sharded seq is psum-merged by SPMD)
        if cfg.num_kv_heads % msize == 0:
            rules["kv_seq"] = None
        else:
            rules["kv_heads"] = None
            rules["kv_seq"] = "model"
    if cfg.ssm_state and msize > 1:
        if cfg.ssm_heads % msize == 0:
            rules["ssm_heads"] = "model"
            rules["ssm_hd"] = None
        elif cfg.ssm_head_dim % msize == 0:
            rules["ssm_heads"] = None
            rules["ssm_hd"] = "model"
        else:
            rules["ssm_heads"] = None
            rules["ssm_hd"] = None
    if overrides:
        rules.update(overrides)
    return rules


def full_dp_rules(cfg, mesh: Mesh) -> Rules:
    """Pure data parallelism: batch sharded over EVERY mesh axis, no model-axis
    sharding of weights or activations.  Optimal for small models (≲1B params)
    where per-layer resharding collectives dwarf the compute — measured in
    EXPERIMENTS.md §Perf (mamba2-130m train: collective term −94.6%)."""
    return make_rules(
        cfg, mesh,
        overrides={
            "batch": ("pod", "data", "model"),
            "kv_batch": ("pod", "data", "model"),
            "seq": None, "tp": None, "ff": None, "vocab": None,
            "experts": None, "heads": None, "seq_q": None,
            "kv_heads": None, "kv_seq": None,
            "ssm_heads": None, "ssm_hd": None,
        },
    )


def mesh_shape(mesh: Mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, for either kind of mesh."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh: Mesh) -> Tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


@dataclass
class ShardCtx:
    mesh: Mesh
    rules: Rules


_TLS = threading.local()


def current_ctx() -> Optional[ShardCtx]:
    return getattr(_TLS, "ctx", None)


@contextmanager
def shard_ctx(mesh: Mesh, rules: Rules):
    prev = current_ctx()
    _TLS.ctx = ShardCtx(mesh, rules)
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev


def bind(fn: Callable) -> Callable:
    """``fn`` run under the context active now, wherever it is called later:
    a checkpoint's recompute runs in the backward, which on a card runs in
    autograd's device thread, where this thread's context is not set."""
    ctx = current_ctx()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with shard_ctx(ctx.mesh, ctx.rules):
            return fn(*args, **kwargs)

    return run


def ctx_axis_size(name: str) -> int:
    """Size of mesh axis ``name`` in the active context (1 without one)."""
    ctx = current_ctx()
    return 1 if ctx is None else _axis_size(ctx.mesh, name)


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _resolve(axis_name: Optional[str], dim: int, mesh: Mesh, rules: Rules):
    """Resolve one logical axis to a mesh-axis entry for PartitionSpec."""
    if axis_name is None:
        return None
    target = rules.get(axis_name, None)
    if target is None:
        return None
    if isinstance(target, str):
        target = (target,)
    # keep only axes present in this mesh
    target = tuple(t for t in target if t in axis_names(mesh))
    # greedy suffix-drop until the dim divides the product of axis sizes
    while target:
        total = int(np.prod([_axis_size(mesh, t) for t in target]))
        if total > 0 and dim % total == 0:
            break
        target = target[:-1]
    if not target:
        return None
    return target if len(target) > 1 else target[0]


def make_pspec(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh: Mesh,
    rules: Rules,
) -> P:
    assert len(logical) == len(shape), (logical, shape)
    used = set()
    entries = []
    for name, dim in zip(logical, shape):
        e = _resolve(name, dim, mesh, rules)
        # a mesh axis may appear at most once in a PartitionSpec
        if e is not None:
            flat = e if isinstance(e, tuple) else (e,)
            if any(a in used for a in flat):
                e = None
            else:
                used.update(flat)
        entries.append(e)
    return P(*entries)


def to_placements(spec: Sequence, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d``'s entry names its axis, else
    ``Replicate()``.  A tuple entry splits its dim over its axes in mesh
    order (DTensor's order, major first); a tuple in another order raises.
    A mesh dim of size 1 gives ``Replicate()``: its one shard is the whole
    tensor, and DTensor's view rules would treat it as a split."""
    names = axis_names(mesh)
    owner: Dict[str, int] = {}
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        for a in axes:
            if a not in names:
                raise ValueError(f"to_placements: {a!r} is not an axis of the mesh {names}")
            if a in owner:
                raise ValueError(f"to_placements: axis {a!r} used twice in {spec}")
            owner[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"to_placements: entry {e} is not in the mesh's axis order {names}; "
                f"DTensor splits a dim over mesh dims major first"
            )
    sizes = mesh_shape(mesh)
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1 else Replicate()
                 for a in names)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Apply a logical sharding constraint if a context is active: a
    ``redistribute`` to the placements the rules give.  A plain tensor inside
    a context raises."""
    ctx = current_ctx()
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain{tuple(logical)}: a plain tensor of shape {tuple(x.shape)} inside "
            f"a sharded step (it left the mesh; create it with replicate())"
        )
    spec = make_pspec(logical, x.shape, ctx.mesh, ctx.rules)
    return redistribute(x, to_placements(spec, ctx.mesh))


def redistribute(x: DTensor, placements: Sequence[Placement]) -> DTensor:
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def replicate(t: torch.Tensor) -> torch.Tensor:
    """A tensor made inside the step, as a ``Replicate()`` DTensor on the
    context's mesh (unchanged without a context, or if it is one already)."""
    ctx = current_ctx()
    if ctx is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, ctx.mesh, [Replicate()] * ctx.mesh.ndim, run_check=False)


def defs_pspecs(defs, mesh: Mesh, rules: Rules):
    """PartitionSpec tree for a ParamDef tree."""
    return tree_map(lambda d: make_pspec(d.logical, d.shape, mesh, rules), defs,
                    is_leaf=is_paramdef)


def defs_shardings(defs, mesh: DeviceMesh, rules: Rules):
    """``(mesh, placements)`` tree for a ParamDef tree."""
    return tree_map(
        lambda d: NamedSharding(mesh, to_placements(make_pspec(d.logical, d.shape, mesh, rules),
                                                    mesh)),
        defs, is_leaf=is_paramdef,
    )


def tree_pspecs(tree_of_logical, tree_of_shapes, mesh: Mesh, rules: Rules):
    """PartitionSpec tree from a tree of logical-axis tuples and a tree of
    the same structure whose leaves are shapes (tuples of ints)."""
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in x)
    is_shape = lambda x: isinstance(x, tuple) and all(isinstance(a, int) for a in x)  # noqa: E731
    logical, treedef = tree_flatten(tree_of_logical, is_leaf=is_axes)
    shapes = tree_flatten(tree_of_shapes, is_leaf=is_shape)[0]
    return tree_unflatten(treedef, [make_pspec(lg, sh, mesh, rules)
                                    for lg, sh in zip(logical, shapes)])


def place(tree, shardings):
    """Put every leaf of ``tree`` on its ``(mesh, placements)``: the
    counterpart of ``jax.device_put(tree, shardings)``.  A leaf that requires
    grad gives a DTensor leaf that requires grad."""

    def one(t, sh):
        d = distribute_tensor(t.detach(), sh.mesh, sh.placements)
        return d.requires_grad_(t.requires_grad)

    return tree_map(one, tree, shardings, is_leaf=lambda x: is_sharding(x))


# ---------------------------------------------------------------------------
# Kernel boundaries
# ---------------------------------------------------------------------------


def keep(placements: Sequence[Placement], dims: Sequence[int]) -> Tuple[Placement, ...]:
    """``placements`` with a ``Shard`` kept only on the tensor dims in
    ``dims``; every other mesh dim (a sharded dim the function cannot take
    locally, a partial sum) becomes ``Replicate()``."""
    dims = set(dims)
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in placements)


def keep_shards(x: DTensor, dims: Sequence[int]) -> Tuple[Placement, ...]:
    """:func:`keep` on ``x``'s placements (negative dims count from the end)."""
    return keep(x.placements, [d % x.dim() for d in dims])


def divisible(placements: Sequence[Placement], dim: int, size: int, mesh: DeviceMesh
              ) -> Tuple[Placement, ...]:
    """``placements`` with tensor dim ``dim`` gathered where the product of
    the mesh dims splitting it does not divide ``size``."""
    split = int(np.prod([mesh.size(i) for i, p in enumerate(placements)
                         if isinstance(p, Shard) and p.dim == dim]))
    if size % split == 0:
        return tuple(placements)
    return tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in placements)


def split_dim(t: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """``t`` with dim ``dim`` reshaped into ``sizes``; a DTensor split along
    that dim over mesh dims whose product does not divide ``sizes[0]`` is
    gathered along it first (DTensor cannot view it otherwise)."""
    if isinstance(t, DTensor):
        t = redistribute(t, divisible(t.placements, dim, sizes[0], t.device_mesh))
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def merge_dims(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with dims ``dim ... dim + n - 1`` merged into one.  A DTensor
    split along a merged dim after the first is gathered along it first (its
    shards are no block of the merged dim, and some versions of DTensor
    refuse the view).  A DTensor's gradient is brought back to the merged
    result's placements before the backward splits it again (a gradient
    split along the merged dim over mesh dims that do not divide its first
    part could not be viewed)."""
    if isinstance(t, DTensor):
        inner = range(dim + 1, dim + n)
        t = redistribute(t, [Replicate() if isinstance(p, Shard) and p.dim in inner else p
                             for p in t.placements])
    out = t.reshape(*t.shape[:dim], -1, *t.shape[dim + n:])
    if isinstance(out, DTensor):
        out = out.redistribute(out.device_mesh, out.placements)
    return out


def ctx_placements(logical: Sequence[Optional[str]], shape: Sequence[int]
                   ) -> Tuple[Placement, ...]:
    """The placements :func:`constrain` would give a tensor of ``shape``."""
    ctx = current_ctx()
    return to_placements(make_pspec(logical, shape, ctx.mesh, ctx.rules), ctx.mesh)


def local_shape(shape: Sequence[int], placements: Sequence[Placement], mesh: DeviceMesh
                ) -> Tuple[int, ...]:
    """A rank's shard shape of an evenly split tensor."""
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def mapped(placements: Sequence[Placement], dim_map: Dict[int, Optional[int]]
           ) -> Tuple[Placement, ...]:
    """Placements of a related tensor: ``Shard(d)`` becomes ``Shard(dim_map[d])``
    (``Replicate()`` where ``d`` has no image)."""
    out = []
    for p in placements:
        nd = dim_map.get(p.dim) if isinstance(p, Shard) else None
        out.append(Shard(nd) if nd is not None else Replicate())
    return tuple(out)


def partial_where_split(placements: Sequence[Placement], split: Sequence[Placement]
                        ) -> Tuple[Placement, ...]:
    """Gradient placements of an input replicated on mesh dims along which
    the work is split (``split`` shards them): each rank's gradient there is
    a partial sum."""
    return tuple(Partial() if isinstance(p, Replicate) and isinstance(s, Shard) else p
                 for p, s in zip(placements, split))


def local_call(fn: Callable, args: Sequence[Any], in_placements: Sequence,
               out_placements, *, grad_placements: Optional[Sequence] = None):
    """``fn(*local shards)`` on each rank, its outputs as DTensors.

    ``in_placements[i]`` is the placements argument ``i`` is redistributed to
    (``None`` for a non-tensor), ``out_placements`` those of ``fn``'s
    outputs (a tuple of them for several outputs), ``grad_placements`` the
    placements of each input's gradient where they differ (``Partial`` for an
    input replicated across split work)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    one = lambda p: None if p is None else list(p)  # noqa: E731
    if out_placements and all(isinstance(p, Placement) for p in out_placements):
        out_placements = one(out_placements)  # a single output
    else:
        out_placements = tuple(one(p) for p in out_placements)
    return local_map(
        fn, out_placements=out_placements, in_placements=tuple(in_placements),
        in_grad_placements=tuple(grad_placements) if grad_placements is not None else None,
        device_mesh=mesh, redistribute_inputs=True,
    )(*args)


def contract(fn: Callable, x: DTensor, w: DTensor) -> DTensor:
    """``fn(x, w)``, a product over ``x``'s last dim and ``w``'s first (``w``
    2-D), run on each rank's shards: DTensor's own rule would flatten ``x``'s
    leading dims into a view, which some versions refuse where a dim after
    the first is split (a split sequence).  On each mesh dim: where ``x``
    splits its last dim, ``w`` is split on its first the same way and the
    result is a partial sum (row parallel); where ``x`` splits another dim,
    ``w`` is whole there; where ``x`` is whole, ``w`` keeps a split of its
    second dim (column parallel); anything else is gathered.  An input whole
    on a mesh dim along which the other is split gets a partial gradient
    there."""
    last = x.dim() - 1
    px, pw, out = [], [], []
    for p, q in zip(x.placements, w.placements):
        if isinstance(p, Shard) and p.dim == last:
            px.append(p), pw.append(Shard(0)), out.append(Partial())
        elif isinstance(p, Shard):
            px.append(p), pw.append(Replicate()), out.append(p)
        elif isinstance(q, Shard) and q.dim == 1:
            px.append(Replicate()), pw.append(q), out.append(Shard(last))
        else:
            px.append(Replicate()), pw.append(Replicate()), out.append(Replicate())
    return local_call(fn, (x, w), (px, pw), tuple(out),
                      grad_placements=(partial_where_split(px, pw), partial_where_split(pw, px)))


def is_sharded(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)
