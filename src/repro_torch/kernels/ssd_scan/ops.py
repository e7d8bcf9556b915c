"""Public SSD-scan wrapper, as ``repro/kernels/ssd_scan/ops.py``.

``ssd_scan`` takes the model's ``(B, S, nh, P)`` layout, folds batch and
heads into ``(B*nh, S, P)``, pre-scales ``da = dt * A`` and runs the chunked
scan: the CUDA kernel (``kernel.py``) for CUDA tensors, which raises on what
it does not take, and the plain version (``ref.ssd_scan_ref``) for CPU
tensors; nothing falls back from one to the other.  The kernel is a forward,
as the reference's is (no VJP); the SSM mixer trains through it with
``model/ssm.py::SSDScan``, whose backward is the vjp of the plain
``ssd_chunked`` (the reference's own backward).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel, ref


def ssd_scan(
    x: torch.Tensor,   # (B, S, nh, P)
    dt: torch.Tensor,  # (B, S, nh)  positive step sizes
    A: torch.Tensor,   # (nh,)       negative
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 128,
):
    """Returns ``(y (B, S, nh, P) in x.dtype, final_state (B, nh, P, N)
    float32)``."""
    B, S, nh, P = x.shape
    xf = x.transpose(1, 2).reshape(B * nh, S, P).contiguous()
    f32 = torch.promote_types(x.dtype, torch.float32)  # float64 stays, for gradcheck
    dtf = dt.transpose(1, 2).reshape(B * nh, S).to(f32).contiguous()
    daf = dtf * A.to(f32).repeat(B)[:, None]
    if x.device.type == "cuda":
        y, state = kernel.ssd_scan_cuda(
            xf, dtf, daf, B_.contiguous(), C_.contiguous(), nheads=nh, chunk=chunk
        )
    else:
        y, state = ref.ssd_scan_ref(xf, dtf, daf, B_, C_, nheads=nh, chunk=chunk)
    y = y.reshape(B, nh, S, P).transpose(1, 2)
    return y, state.reshape(B, nh, P, state.shape[-1])
