"""Per-device cost of one step, counted from the ops it dispatches (port of
``repro/launch/hlo_analysis.py``).

The reference parses the post-SPMD HLO of a compiled step: dot FLOPs, the
operand and result bytes at fusion boundaries, and every collective with an
ICI/DCN split, multiplying ``while`` bodies by their trip counts.  Eager
PyTorch has no HLO and no loops to multiply: the port's step is the op
sequence it dispatches, layer by layer, microbatch by microbatch, forward,
backward and checkpoint recompute.  :class:`StepCounter` is a
``TorchDispatchMode`` that counts that sequence and keeps the reference's
:class:`Stats` fields and :func:`stats_dict` keys (``flops``, ``bytes``,
``bytes_fused``, ``collective_bytes``, ``ici_bytes``, ``dcn_bytes``,
``per_op``).

What the count sees.  A dispatch mode entered around a sharded step sees
each DTensor op once, with global shapes (a sharded matmul would count the
whole product on every device).  So the counter declines DTensor (and
``AsyncCollectiveTensor``) operands: DTensor then redistributes and runs
the op on each rank's shards under the same mode, and the counter sees
those local ops and the collectives DTensor runs for them.  Every count
is rank 0's: its shards' shapes.  Ops on plain tensors (an unsharded step,
the inside of a ``local_map`` kernel boundary, the model's own
``torch.distributed`` calls) are counted as they are.

* ``flops``: ``torch.utils.flop_counter``'s formula of each local op (2·M·N·K
  for the matmul family, as ``_dot_flops`` in the reference; convolutions
  and attention ops by their own formulas), so a step's count equals what
  ``FlopCounterMode`` counts on the same plain tensors.
* ``bytes``: operand plus result bytes of every dispatched op except views,
  aliases and allocations that write nothing (the eager upper estimate:
  every op is its own pass over memory).
* ``bytes_fused``: the same sum over :data:`BYTES_OPS_FUSED`, the aten
  counterparts of the reference's ``_BYTES_OPS_FUSED`` (dots, convolutions,
  sorts, gathers and scatters, slice updates, reductions and scans): the
  lower estimate, with every elementwise chain fused into those passes.
* collectives: count and operand bytes per kind; one whose process group
  spans ranks of two pods (``rank // pod_size``) counts as DCN, every other
  as ICI, as the reference's replica-group check does.

What it cannot see.  Which ops a compiler would fuse (``bytes`` counts each
separately; ``bytes_fused`` guesses the fusion as the reference does); the
kernels of ``use_kernels="cuda"`` (a meta trace runs the plain versions,
whose FLOPs are those of the products they replace); overlap of compute and
communication; and, on a ``cpu`` mesh, DTensor's all-to-all, which it
replaces by an all-gather and a local chunk (counted as such).

:class:`StepCounter` also keeps the live bytes of every storage an op
creates, with a weak reference to each (``peak_bytes``): the memory term of
the dry-run.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast",
)

aten = torch.ops.aten

# (namespace, op name) -> (collective kind, index of the operand argument).
# The functional collectives DTensor runs take their input first; the
# c10d ops behind ``torch.distributed.*`` take (outputs, inputs) where they
# gather, scatter or exchange.
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast",
}
_COLLECTIVE_OPS = {
    **{("_c10d_functional", k): (v, 0) for k, v in _FUNCTIONAL.items()},
    **{("_c10d_functional_autograd", k): (v, 0) for k, v in _FUNCTIONAL.items()},
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", 0),
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_coalesced_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "broadcast_"): ("collective-broadcast", 0),
    ("c10d", "send"): ("collective-permute", 0),
    ("c10d", "recv_"): ("collective-permute", 0),
    ("c10d", "recv_any_source_"): ("collective-permute", 0),
    ("_c10d_functional", "isend"): ("collective-permute", 0),
    ("_c10d_functional", "irecv"): ("collective-permute", 0),
    # DTensor's Shard(i) -> Shard(j) on a mesh of a device type other than cpu
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", 0),
}

# Ops that move no bytes: allocations that write nothing, aliases, and the
# bookkeeping around the collectives (views are found by ``is_view``).
_NO_BYTES = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten._local_scalar_dense, aten.set_,
}
_NO_BYTES_NAMES = {"wait_tensor", "_wrap_tensor_autograd"}

# The reference's ``_BYTES_OPS_FUSED`` (dot, convolution, sort, gather,
# scatter, dynamic-slice, dynamic-update-slice, reduce, reduce-window, ...)
# as the aten ops that carry them in an eager step.
BYTES_OPS_FUSED = {
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.addbmm, aten._scaled_mm,
    aten.convolution, aten.convolution_backward,
    aten.sort, aten.topk,
    aten.gather, aten.index, aten.index_select, aten.embedding,
    aten.embedding_dense_backward,
    aten.scatter, aten.scatter_add, aten.scatter_reduce, aten.index_put,
    aten._index_put_impl_, aten.index_add, aten.index_copy,
    aten.slice_scatter, aten.select_scatter, aten.copy_,
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.prod,
    aten.logsumexp, aten.linalg_vector_norm, aten.cumsum, aten.cumprod,
    aten._softmax, aten._log_softmax,
}


@dataclass
class Stats:
    flops: float = 0.0
    bytes: float = 0.0
    bytes_fused: float = 0.0  # perfect-fusion (lower) traffic estimate
    coll: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: {k: {"bytes": 0.0, "count": 0.0} for k in COLLECTIVES}
    )
    ici_bytes: float = 0.0
    dcn_bytes: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.coll.values())


def stats_dict(st: Stats) -> Dict:
    return {
        "flops": st.flops,
        "bytes": st.bytes,
        "bytes_fused": st.bytes_fused,
        "collective_bytes": st.collective_bytes,
        "ici_bytes": st.ici_bytes,
        "dcn_bytes": st.dcn_bytes,
        "per_op": {k: dict(v) for k, v in st.coll.items()},
    }


def _tensors(x: Any):
    """The tensors in ``x`` (nested tuples, lists and dicts), in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def tensor_bytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree`` (a DTensor counts its local shard)."""
    total = 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _storage(t: torch.Tensor):
    return (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()


def _group_ranks(group) -> list:
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):  # a c10d op's boxed group
        group = dist.ProcessGroup.unbox(group)
    return dist.get_process_group_ranks(group)


_COMPOSITE: Dict[Any, bool] = {}


def _composite(func) -> bool:
    """Whether ``func`` has no formula of its own and a composite kernel
    to decompose into."""
    c = _COMPOSITE.get(func)
    if c is None:
        c = _COMPOSITE[func] = (
            func._overloadpacket not in flop_registry
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"))
    return c


def _declines(types: Iterable[type]) -> bool:
    """Operands the counter leaves to their own dispatch: DTensor runs the
    op on its shards (which the counter then sees), an
    ``AsyncCollectiveTensor`` waits and unwraps."""
    return any(issubclass(t, DTensor) or t.__name__ == "AsyncCollectiveTensor"
               for t in types)


class StepCounter(TorchDispatchMode):
    """Counts the local ops dispatched while it is active (see the module
    docstring); ``stats`` holds the totals, ``flops_by_op`` the FLOPs per
    aten op, ``peak_bytes`` the most bytes live at once in storages it saw
    created or was given by :meth:`hold`."""

    def __init__(self, pod_size: int = 256):
        super().__init__()
        self.pod_size = pod_size
        self.stats = Stats()
        self.flops_by_op: Dict[str, float] = {}  # aten packet name -> FLOPs
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, Any] = {}  # id(storage) -> weakref to it

    # -- memory ---------------------------------------------------------------
    def hold(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors as live (the step's
        arguments, held by the caller throughout)."""
        for t in _tensors(tree):
            self._track(_storage(t))

    def _track(self, st) -> None:
        key = id(st)
        if key in self._live and self._live[key]() is st:
            return
        nbytes = st.nbytes()

        def freed(ref, key=key, nbytes=nbytes):
            if self._live.get(key) is ref:
                del self._live[key]
            self.live_bytes -= nbytes

        self._live[key] = weakref.ref(st, freed)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- ops ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _declines(types):
            return NotImplemented
        if any(t is not torch.Tensor for t in types) or torch._C._meta_in_tls_dispatch_include():
            # a FakeTensor, or the meta kernels a FakeTensorMode runs: DTensor's
            # sharding propagation on global shapes, which no rank executes
            return func(*args, **kwargs)
        if _composite(func):
            # a composite op (reached as one where autograd is off, as under
            # inference_mode) is counted as the ops it decomposes into, as
            # FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        for t in _tensors(out):
            if type(t) is torch.Tensor:
                self._track(t.untyped_storage())
        return out

    def _count(self, func, args, kwargs, out) -> None:
        st = self.stats
        ns, name = func._schema.name.split("::")
        coll = _COLLECTIVE_OPS.get((ns, name))
        if coll is not None:
            kind, at = coll
            b = tensor_bytes(args[at])
            st.coll[kind]["bytes"] += b
            st.coll[kind]["count"] += 1
            st.bytes += b + tensor_bytes(out)
            group = self._group_arg(func, args, kwargs)
            ranks = _group_ranks(group) if group is not None else []
            if len({r // self.pod_size for r in ranks}) > 1:
                st.dcn_bytes += b
            else:
                st.ici_bytes += b
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            st.flops += f
            self.flops_by_op[str(packet)] = self.flops_by_op.get(str(packet), 0.0) + f
        if func.is_view or packet in _NO_BYTES or name in _NO_BYTES_NAMES:
            return
        b = tensor_bytes((args, kwargs)) + tensor_bytes(out)
        st.bytes += b
        if packet in BYTES_OPS_FUSED:
            st.bytes_fused += b

    @staticmethod
    def _group_arg(func, args, kwargs) -> Optional[Any]:
        for i, a in enumerate(func._schema.arguments):
            if a.name in ("group_name", "process_group"):
                return kwargs[a.name] if a.name in kwargs else (
                    args[i] if i < len(args) else None)
        return None
