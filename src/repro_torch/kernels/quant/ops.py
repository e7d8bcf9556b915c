"""Public int8 quant / dequant wrappers, as ``repro/kernels/quant/ops.py``.

``quantize_int8(x)`` flattens the leading dims to rows and runs the CUDA
kernel (``kernel.py``) for CUDA tensors, which raises on what it does not
take, and the plain version (``ref.py``) for CPU tensors; nothing falls back
from one to the other.  The kernel takes any row count (no ``block_r``), so
the wrapper has no divisibility rule to meet.  Dequantization is plain, in
the reference too.  On DTensors the rows may stay sharded
(``sharding.local_call``); the last axis is gathered.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.quant import kernel, ref


def quantize_int8(x: torch.Tensor):
    """``x (..., d) -> (q int8 of x's shape, scale float32 (..., 1))``,
    symmetric per row of the last axis."""
    from repro_torch.distributed import sharding as sh

    if sh.is_sharded(x):
        px = sh.keep_shards(x, range(x.dim() - 1))
        return sh.local_call(quantize_int8, (x,), (px,), (px, px))
    shape = tuple(x.shape)
    x2 = x.reshape(math.prod(shape[:-1]), shape[-1])
    if x2.device.type == "cuda":
        q, s = kernel.quantize_int8_cuda(x2.contiguous())
    else:
        q, s = ref.quantize_int8_ref(x2)
    return q.reshape(shape), s.reshape(shape[:-1] + (1,))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return ref.dequantize_int8_ref(q, scale, dtype)
