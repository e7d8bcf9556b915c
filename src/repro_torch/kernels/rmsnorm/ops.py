"""Public RMSNorm wrapper, as ``repro/kernels/rmsnorm/ops.py``: flattens the
leading dims to rows and runs ``RMSNorm``, a ``torch.autograd.Function``.

Its forward is the CUDA kernel (``kernel.py``) for CUDA tensors, which raises
on what it does not take, and the plain version (``ref.py``) for CPU
tensors; nothing falls back from one to the other.  The reference has no
backward kernel for RMSNorm, so the backward is the closed-form gradient in
plain torch ops (``ref.rmsnorm_bwd_ref``) on either device.

On DTensors every dim but the last may stay sharded (``sharding.local_call``);
the scale is replicated, and its gradient is a partial sum over the split
rows.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel, ref


def rmsnorm_fwd(x2: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(R, d) rows -> (R, d): the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x2.device.type == "cuda":
        return kernel.rmsnorm_cuda(x2, scale, eps)
    return ref.rmsnorm_ref(x2, scale, eps)


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, eps: float):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x2, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dx, dscale = ref.rmsnorm_bwd_ref(x2, scale, dy, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x (..., d)`` with ``scale (d,)``, differentiable."""
    from repro_torch.distributed import sharding as sh

    if not sh.is_sharded(x, scale):
        return _rmsnorm_local(x, scale, eps)
    px = sh.keep_shards(x, range(x.dim() - 1))
    rep = (sh.Replicate(),) * len(px)
    return sh.local_call(lambda x, s: _rmsnorm_local(x, s, eps), (x, scale), (px, rep), px,
                         grad_placements=(px, sh.partial_where_split(rep, px)))


def _rmsnorm_local(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    shape = x.shape
    y = RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), scale.contiguous(), eps)
    return y.reshape(shape)
