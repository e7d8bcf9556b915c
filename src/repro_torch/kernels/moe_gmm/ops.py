"""Public grouped-matmul wrapper, as ``repro/kernels/moe_gmm/ops.py``.

``grouped_matmul(x, w)`` is ``GroupedMatmul``, a ``torch.autograd.Function``.
Its forward runs the CUDA kernel (``kernel.py``) for CUDA tensors, which
raises on what it does not take, and the plain version (``ref.py``) for CPU
tensors; nothing falls back from one to the other.  The reference's kernel
has no VJP (it trains by autodiff of an ``einsum``), so the backward is:

* ``dx = dy . w^T``: the same kernel (the plain version on CPU tensors) on
  ``dy`` and a contiguous ``(E, f, d)`` copy of ``w`` transposed;
* ``dw = x^T . dy`` per expert: one ``torch.bmm`` with a float32 result,
  rounded once to ``w.dtype`` (the reference's float32-accumulated einsum);
  on CPU tensors, which that call has no kernel for, the same product on
  float32 (float64) casts.

On DTensors the product runs on each rank's shards (``sharding.local_call``):
the group (expert) dim and the rows of ``x`` may stay sharded, ``w`` follows
``x``'s expert split and is gathered elsewhere; so dx and dW are computed on
the shards too, dW a partial sum over split rows.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm import kernel, ref


def _gmm(x: torch.Tensor, w: torch.Tensor, dx: bool = False) -> torch.Tensor:
    if x.device.type == "cuda":
        return kernel.grouped_matmul_cuda(x, w, dx=dx)
    return ref.grouped_matmul_ref(x, w)


def _dw(x: torch.Tensor, dy: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x^T . dy`` per expert: (E, C, d), (E, C, f) -> (E, d, f) in ``dtype``."""
    if x.is_cuda and x.dtype == dy.dtype and x.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(x.transpose(1, 2), dy, out_dtype=torch.float32).to(dtype)
    f32 = torch.promote_types(x.dtype, torch.float32)
    return torch.bmm(x.transpose(1, 2).to(f32), dy.to(f32)).to(dtype)


class GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm(dy, w.transpose(1, 2).contiguous(), dx=True)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, dy, w.dtype)
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (E, C, d) x w (E, d, f) -> (E, C, f)`` in ``x.dtype``, float32
    accumulation; differentiable."""
    from repro_torch.distributed import sharding as sh

    if not sh.is_sharded(x, w):
        return GroupedMatmul.apply(x, w)
    px = sh.keep_shards(x, (0, 1))
    pw = sh.mapped(px, {0: 0})
    return sh.local_call(GroupedMatmul.apply, (x, w), (px, pw), px,
                         grad_placements=(px, sh.partial_where_split(pw, px)))
