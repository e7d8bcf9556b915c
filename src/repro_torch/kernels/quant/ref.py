"""Plain PyTorch version of the int8 quantization kernel (``quantize_int8_fwd``
of ``repro/kernels/quant/kernel.py``), the oracle the CUDA kernel is held to;
it computes what ``repro/kernels/quant/ref.py`` computes, bit for bit."""

from __future__ import annotations

import torch


def quantize_int8_ref(x: torch.Tensor):
    """Per row of the last axis, symmetric int8: ``(q int8 like x, scale
    float32 (..., 1))``.

    In float32: ``scale = max(amax, 1e-12) / 127`` and ``q = clip(round(x /
    scale), -127, 127)``, both divisions IEEE (the 127 is a tensor: torch
    multiplies by the reciprocal of a Python-scalar divisor on the card),
    rounding half to even.  ``amax`` and the clamp propagate NaN, as
    ``jnp.max`` and ``jnp.maximum`` do, so a row that holds NaN gets a NaN
    scale, and one that holds an infinity an infinite one; an element that is
    NaN after the round becomes 0 (XLA's conversion; a NaN cast to int8 is
    undefined in torch), so such rows are all zeros.
    """
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
    r = torch.round(xf / scale)
    q = torch.where(torch.isnan(r), 0.0, r.clamp(-127.0, 127.0)).to(torch.int8)
    return q, scale


def dequantize_int8_ref(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    """``q * scale`` in float32, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)
