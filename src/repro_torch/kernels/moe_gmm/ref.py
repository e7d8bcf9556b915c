"""Plain PyTorch version of the grouped-matmul kernel (``grouped_matmul_fwd``
of ``repro/kernels/moe_gmm/kernel.py``), the oracle the CUDA kernel is held
to, as ``repro/kernels/moe_gmm/ref.py`` is the Pallas kernel's."""

from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(E, C, d) x (E, d, f) -> (E, C, f)``: float32 products and sums
    (float64 for float64 inputs), one rounding to ``x.dtype``."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    return torch.einsum("ecd,edf->ecf", x.to(f32), w.to(f32)).to(x.dtype)
