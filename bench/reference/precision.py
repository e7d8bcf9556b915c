"""The precision the reference computes its products in.

``Precision("float32")`` is the reference: every product in float32 with
TF32 off.  ``Precision("fp8")`` is the control, the step below the
configurations' bfloat16 that a later change could be tempted by: each
operand of every product rounded to float8 (e4m3 forward, e5m2 for the
gradients in the backward, as fp8 training does) under one scale a tensor
that maps its largest magnitude to the format's largest, the product then
taken in float32.
"""

from __future__ import annotations

import torch

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def float32_products() -> None:
    """Products in full float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """t rounded to ``fmt`` under a per-tensor scale, back in float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8[fmt], torch.ones_like(amax))
    return (t / scale).to(fmt).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8_round(a, torch.float8_e4m3fn), fp8_round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = fp8_round(g, torch.float8_e5m2)
        ga = torch.matmul(g8, b8.transpose(-1, -2))
        gb = torch.matmul(a8.transpose(-1, -2), g8)
        # undo broadcasting over leading dims
        while ga.dim() > a8.dim():
            ga = ga.sum(0)
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        for dim, (n_g, n_t) in enumerate(zip(ga.shape[:-2], a8.shape[:-2])):
            if n_t == 1 and n_g != 1:
                ga = ga.sum(dim, keepdim=True)
        for dim, (n_g, n_t) in enumerate(zip(gb.shape[:-2], b8.shape[:-2])):
            if n_t == 1 and n_g != 1:
                gb = gb.sum(dim, keepdim=True)
        return ga, gb


class Precision:
    """``name`` is ``float32`` (the reference) or ``fp8`` (the control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}, not 'float32' or 'fp8'")
        self.name = name

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(a, b)
