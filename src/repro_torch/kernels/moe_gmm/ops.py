"""Public grouped-matmul wrapper, as ``repro/kernels/moe_gmm/ops.py``.

``grouped_matmul(x, w)`` runs the CUDA kernel (``kernel.py``) for CUDA
tensors, which raises on what it does not take, and the plain version
(``ref.py``) for CPU tensors; nothing falls back from one to the other.  It
is forward only, as the reference's kernel is (no VJP): the MoE FFN refuses
the kernel path under autograd.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm import kernel, ref


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (E, C, d) x w (E, d, f) -> (E, C, f)`` in ``x.dtype``, float32
    accumulation."""
    if x.device.type == "cuda":
        return kernel.grouped_matmul_cuda(x, w)
    return ref.grouped_matmul_ref(x, w)
