"""Public SSD-scan wrapper, as ``repro/kernels/ssd_scan/ops.py``.

``ssd_scan`` takes the model's ``(B, S, nh, P)`` layout, folds batch and
heads of the step sizes into ``(B*nh, S)``, pre-scales ``da = dt * A`` and
runs the chunked scan: the CUDA kernels (``kernel.py``) for CUDA tensors,
which read x and write y in the model's layout and raise on what they do
not take, and the plain version (``ref.ssd_scan_ref``, which takes x folded
to ``(B*nh, S, P)``) for CPU tensors; nothing falls back from one to the
other.  The reference's kernel is a forward alone (JAX differentiates the
plain ``ssd_chunked``); the SSM mixer trains through
``model/ssm.py::SSDScan``, whose backward on bfloat16 CUDA tensors is
:func:`ssd_scan_bwd`, the backward kernels (``kernel.ssd_scan_bwd_cuda``),
and on the others the vjp of the plain ``ssd_chunked``.

On DTensors (:func:`on_shards`) batch and SSD heads may stay sharded; the
sequence and the head dim are gathered first, and the inputs shared across a
head split (``B``, ``C``) or a batch split (``A``) take partial gradients.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel, ref


def on_shards(fn, x, dt, A, B_, C_):
    """``fn(x, dt, A, B_, C_) -> (y, final_state)`` with ``ssd_scan``'s
    layout, run on each rank's shards when the inputs are DTensors (else
    called as it is)."""
    from repro_torch.distributed import sharding as sh

    if not sh.is_sharded(x, dt, A, B_, C_):
        return fn(x, dt, A, B_, C_)
    px = sh.keep_shards(x, (0, 2))
    pdt, pa, pbc = sh.mapped(px, {0: 0, 2: 2}), sh.mapped(px, {2: 0}), sh.mapped(px, {0: 0})
    ins = (px, pdt, pa, pbc, pbc)
    grads = tuple(sh.partial_where_split(p, px) for p in ins)
    return sh.local_call(fn, (x, dt, A, B_, C_), ins, (px, sh.mapped(px, {0: 0, 2: 1})),
                         grad_placements=grads)


def ssd_scan(x, dt, A, B_, C_, *, chunk: int = 128):
    """The chunked scan (:func:`ssd_scan_local`), on each rank's shards for
    DTensors."""
    return on_shards(lambda *a: ssd_scan_local(*a, chunk=chunk), x, dt, A, B_, C_)


def ssd_scan_local(
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
    f32 = torch.promote_types(x.dtype, torch.float32)  # float64 stays, for gradcheck
    dtf = dt.transpose(1, 2).reshape(B * nh, S).to(f32).contiguous()
    daf = dtf * A.to(f32).repeat(B)[:, None]
    if x.device.type == "cuda":
        y, state = kernel.ssd_scan_cuda(x.contiguous(), dtf, daf, B_.contiguous(),
                                        C_.contiguous(), chunk=chunk)
    else:
        xf = x.transpose(1, 2).reshape(B * nh, S, P).contiguous()
        y, state = ref.ssd_scan_ref(xf, dtf, daf, B_, C_, nheads=nh, chunk=chunk)
        y = y.reshape(B, nh, S, P).transpose(1, 2)
    return y, state.reshape(B, nh, P, state.shape[-1])


def ssd_scan_bwd(x, dt, A, B_, C_, gy, gstate, *, chunk: int):
    """The cotangents of :func:`ssd_scan_local`'s inputs from y's (``gy``)
    and the final state's (``gstate``; either may be ``None``, zero) through
    the bfloat16 backward kernels (``kernel.ssd_scan_bwd_cuda``): ``(dx, ddt,
    dA, dB, dC)`` in the inputs' layouts and dtypes.  x, y's cotangent and dx
    stay in the model's layout; ``da`` is formed as the forward forms it."""
    B, S, nh, P = x.shape
    dtf = dt.transpose(1, 2).reshape(B * nh, S).to(torch.float32).contiguous()
    Af = A.to(torch.float32).contiguous()
    daf = dtf * Af.repeat(B)[:, None]
    gy = torch.zeros_like(x) if gy is None else gy.to(x.dtype).contiguous()
    gsf = None if gstate is None else gstate.reshape(B * nh, P, -1).to(torch.float32).contiguous()
    dx, ddt, dA, dB, dC = kernel.ssd_scan_bwd_cuda(x.contiguous(), dtf, daf, Af, B_.contiguous(),
                                                   C_.contiguous(), gy, gsf, chunk=chunk)
    return dx, ddt.reshape(B, nh, S).transpose(1, 2).to(dt.dtype), dA.to(A.dtype), dB, dC
