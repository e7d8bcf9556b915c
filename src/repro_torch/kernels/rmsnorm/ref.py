"""Plain PyTorch version of the RMSNorm kernel (``rmsnorm_fwd`` of
``repro/kernels/rmsnorm/kernel.py``), the oracle the CUDA kernel is held to;
it matches ``model/layers.rms_norm`` as the reference's oracle does."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per row of the last axis: float32 mean of squares, ``x * rsqrt(ms +
    eps) * scale``, cast to ``x.dtype``."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The closed-form gradient of :func:`rmsnorm_ref`, in float32:
    ``dx = r * (g - xhat * mean(g * xhat))`` with ``r = rsqrt(ms + eps)``,
    ``xhat = x * r`` and ``g = dy * scale``; ``dscale = sum over rows of dy *
    xhat``.  Returns ``(dx in x.dtype, dscale in scale.dtype)``."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.float()
    g = dyf * scale.float()
    dx = r * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
