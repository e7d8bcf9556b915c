"""Gradient compression for slow links, as ``repro/distributed/compression.py``.

Two pieces:

  * ``ef_compress_grads`` — int8 error-feedback compression of a gradient
    tree: every leaf is quantized per row (``kernels/quant``), and the
    quantization residual is carried in the error state and added back the
    next time (error feedback keeps the scheme unbiased in the long run).
  * ``all_reduce_int8`` — an int8 all-gather-based all-reduce over a
    ``torch.distributed`` process group (NCCL on the card, gloo on the CPU):
    a mesh axis of the active ``shard_ctx`` named as in the reference
    (``axis``, that mesh dim's group), or a group given as it is.

``use_kernels`` takes the values of ``ModelConfig.use_kernels``: ``"cuda"``
quantizes through ``kernels.quant.quantize_int8`` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors), ``"off"`` through the plain
``quantize_int8_ref``, where the reference calls its ref.  The leaf rules are
the reference's: a 0-d leaf passes through, a 1-D leaf is one row ``(1, n)``,
any other is ``(-1, last)``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.quant.ref import dequantize_int8_ref, quantize_int8_ref
from repro_torch.pytree import tree_map

PyTree = Any


def _quantizer(use_kernels: str):
    if use_kernels == "cuda":
        from repro_torch.kernels.quant import quantize_int8

        return quantize_int8
    if use_kernels != "off":
        raise ValueError(f"use_kernels={use_kernels!r}, not 'off' or 'cuda'")
    return quantize_int8_ref


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]) if x.dim() > 1 else x.reshape(1, -1)


def init_ef_state(grads_like: PyTree) -> PyTree:
    """Float32 zeros shaped like the gradients, on their devices."""
    return tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like
    )


def _roundtrip(x: torch.Tensor, quantize) -> torch.Tensor:
    """Quantize -> dequantize (the wire format of the compressed collective)."""
    if x.dim() == 0:
        return x
    q, s = quantize(_rows(x))
    return dequantize_int8_ref(q, s, torch.float32).reshape(x.shape)


def ef_compress_grads(
    grads: PyTree, ef_state: PyTree, use_kernels: str = "cuda"
) -> Tuple[PyTree, PyTree]:
    """Error-feedback int8 round trip on every gradient leaf.

    Returns ``(compressed grads, new error state)``, ``err' = (g + err) -
    Q(g + err)``.  The error state is updated IN PLACE (one float32 copy of
    the tree fewer than the reference's pure function; the sums are the
    same): the returned state holds the tensors of ``ef_state``.
    """
    quantize = _quantizer(use_kernels)

    def one(g, e):
        gf = e.add_(g)  # g + err in float32, in err's storage
        qd = _roundtrip(gf, quantize)  # gf itself for a 0-d leaf
        out = qd.to(g.dtype, copy=qd is gf)
        gf.sub_(qd)
        return out, gf

    flat = tree_map(one, grads, ef_state)
    is_pair = lambda t: isinstance(t, tuple)
    new_g = tree_map(lambda t: t[0], flat, is_leaf=is_pair)
    new_e = tree_map(lambda t: t[1], flat, is_leaf=is_pair)
    return new_g, new_e


def all_reduce_int8(x: torch.Tensor, axis: Optional[str] = None, *, group=None,
                    use_kernels: str = "cuda") -> torch.Tensor:
    """Int8 all-gather + local sum over the ranks of mesh axis ``axis`` of
    the active ``shard_ctx`` (``mesh.get_group(axis)``), or over ``group``
    (the default group when both are None): every rank quantizes its ``x``,
    gathers every rank's codes and scales, and sums the dequantized shards in
    rank order in float32.

    Wire cost per rank: (N-1)·B/4 int8 against 2·(N-1)/N·B float32 for a
    ring all-reduce.
    """
    if axis is not None:
        from repro_torch.distributed.sharding import current_ctx

        ctx = current_ctx()
        if ctx is None or group is not None:
            raise ValueError(f"all_reduce_int8(axis={axis!r}) needs a shard_ctx and no group")
        group = ctx.mesh.get_group(axis)
    q, s = _quantizer(use_kernels)(_rows(x))
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q.contiguous(), group=group)
    dist.all_gather(ss, s.contiguous(), group=group)
    acc = dequantize_int8_ref(qs[0], ss[0])
    for qr, sr in zip(qs[1:], ss[1:]):
        acc = acc + dequantize_int8_ref(qr, sr)
    return acc.reshape(x.shape).to(x.dtype)
