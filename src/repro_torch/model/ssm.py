"""Mamba-2 / SSD sequence mixer (port of ``repro/model/ssm.py``; state-space
duality, arXiv:2405.21060), with the reference's sharding constraints.

Prefill runs the chunked SSD algorithm: within a chunk the dual
(attention-like) quadratic form, across chunks a linear recurrence on the
carried state.  Decode is the exact single-step recurrence on the SSM state.
``cfg.use_kernels`` picks the chunked scan of prefill:

  * ``"off"``  — :func:`ssd_chunked`, the reference's plain path, kept
    exactly (its ``w.astype(xc.dtype)`` rounding included);
  * ``"cuda"`` — :class:`SSDScan`: the forward is ``kernels.ssd_scan.
    ssd_scan`` (the CUDA kernel on CUDA tensors, its plain version on CPU
    tensors, never a fallback between them), the backward the vjp of
    :func:`ssd_chunked`, as the reference's (it has no backward kernel).

The gated norm runs through ``layers.rms_norm`` in the same mode.  The
softplus of the step sizes is ``logaddexp(x, 0)``, the reference's
``jax.nn.softplus`` formula; ``F.softplus`` would turn linear above 20, an
error below 3e-9.  The reference's ``jax.checkpoint`` around the chunk body
is not needed: the port recomputes per block (``lm.forward_hidden``).

Under a ``shard_ctx`` the projections carry the reference's constraints
(``ssm_heads`` or ``ssm_hd``, as ``make_rules`` picks) and the chunked scan,
in either mode, runs on each rank's batch and head shards
(``kernels/ssd_scan/ops.py::on_shards``); the scan's inner constraints have
no counterpart there, since a rank scans its shard whole.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.ssd_scan.ops import on_shards
from repro_torch.model.layers import ParamDef, dense, rms_norm, silu
from repro_torch.observability.spans import span


def ssm_defs(cfg) -> Dict[str, ParamDef]:
    d, di, ds, nh, w = (
        cfg.d_model,
        cfg.d_inner,
        cfg.ssm_state,
        cfg.ssm_heads,
        cfg.ssm_conv_width,
    )
    return {
        "w_x": ParamDef((d, di), ("fsdp", "tp")),
        "w_z": ParamDef((d, di), ("fsdp", "tp")),
        "w_b": ParamDef((d, ds), ("fsdp", None)),
        "w_c": ParamDef((d, ds), ("fsdp", None)),
        "w_dt": ParamDef((d, nh), ("fsdp", None)),
        "conv_x": ParamDef((w, di), (None, "tp"), scale=0.5),
        "conv_b": ParamDef((w, ds), (None, None), scale=0.5),
        "conv_c": ParamDef((w, ds), (None, None), scale=0.5),
        "a_log": ParamDef((nh,), (None,), init="ssm_a", dtype="float32"),
        "dt_bias": ParamDef((nh,), (None,), init="ssm_dt", dtype="float32"),
        "d_skip": ParamDef((nh,), (None,), init="ones", dtype="float32"),
        "norm": ParamDef((di,), (None,), init="ones", dtype="float32"),
        "w_out": ParamDef((di, d), ("tp", "fsdp")),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); kernel: (W, C).  On DTensors it
    runs on each rank's shards, the batch and channels kept split and the
    sequence whole (DTensor's rule for the broadcast product fails in some
    versions); the kernel's gradient is a partial sum over a batch split."""
    if sh.is_sharded(x, kernel):
        px = sh.keep_shards(x, (0, 2))
        pk = sh.mapped(px, {2: 1})
        return sh.local_call(_causal_conv, (x, kernel), (px, pk), px,
                             grad_placements=(px, sh.partial_where_split(pk, px)))
    W = kernel.shape[0]
    S = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S, :] * kernel[i].to(x.dtype) for i in range(W))
    return out


def _conv_step(x_t: torch.Tensor, state: torch.Tensor, kernel: torch.Tensor):
    """x_t: (B, 1, C); state: (B, W-1, C) last inputs.  Returns (y_t, new_state)."""
    window = torch.cat([state, x_t], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window, kernel.to(x_t.dtype))[:, None, :]
    return y, window[:, 1:, :]


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(
    x: torch.Tensor,   # (B, S, nh, hd) — already dt-independent input
    dt: torch.Tensor,  # (B, S, nh) — positive step sizes
    A: torch.Tensor,   # (nh,) — negative
    B_: torch.Tensor,  # (B, S, ds)
    C_: torch.Tensor,  # (B, S, ds)
    chunk: int,
    state0: Optional[torch.Tensor] = None,  # (B, nh, hd, ds)
):
    """Chunked SSD.  Returns (y (B,S,nh,hd), final_state (B,nh,hd,ds)).

    Float32 inside, as the reference (float64 for float64 inputs, which
    ``torch.autograd.gradcheck`` needs).  The decay above the diagonal is
    selected away before the exponential as well as after it: ``exp`` of
    those (positive) segment sums overflows over a long chunk, and its
    gradient, 0 * inf, would be NaN where the reference's vjp is; the
    forward is the reference's bit for bit."""
    B, S, nh, hd = x.shape
    ds = B_.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the chunk {chunk}")
    f32 = torch.promote_types(x.dtype, torch.float32)
    state = state0 if state0 is not None else torch.zeros(
        (B, nh, hd, ds), dtype=f32, device=x.device
    )
    rows = torch.arange(chunk, device=x.device)
    causal = (rows[:, None] >= rows[None, :])[None, :, :, None]
    ys = []
    for c0 in range(0, S, chunk):
        xc = x[:, c0:c0 + chunk]  # (B,Q,nh,hd)
        dtc = dt[:, c0:c0 + chunk].to(f32)  # (B,Q,nh)
        bc, cc = B_[:, c0:c0 + chunk], C_[:, c0:c0 + chunk]  # (B,Q,ds)
        da = dtc * A  # (B,Q,nh), negative
        a_cs = torch.cumsum(da, dim=1)  # inclusive cumsum
        # intra-chunk (dual quadratic form)
        seg = a_cs[:, :, None, :] - a_cs[:, None, :, :]  # (B,Q,K,nh): sum_{k+1..q}
        L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)  # (B,Q,K,nh)
        scores = torch.einsum("bqn,bkn->bqk", cc.to(f32), bc.to(f32))
        w = scores[:, :, :, None] * L * dtc[:, None, :, :]  # (B,Q,K,nh)
        y_diag = torch.einsum("bqkh,bkhp->bqhp", w.to(xc.dtype).to(f32), xc.to(f32))
        # contribution of the carried state
        y_inter = torch.einsum("bqn,bhpn->bqhp", cc.to(f32), state) * torch.exp(
            a_cs
        )[:, :, :, None]
        # state update
        decay_to_end = torch.exp(a_cs[:, -1:, :] - a_cs)  # (B,Q,nh)
        state_in = torch.einsum(
            "bkh,bkn,bkhp->bhpn", dtc * decay_to_end, bc.to(f32), xc.to(f32)
        )
        state = state * torch.exp(a_cs[:, -1])[:, :, None, None] + state_in
        ys.append((y_diag + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y, state


class SSDScan(torch.autograd.Function):
    """The chunked scan with ``state0 = None``, differentiable.  Forward:
    ``kernels.ssd_scan.ops.ssd_scan`` (the CUDA kernel on CUDA tensors,
    raising on what it does not take; its plain version on CPU tensors).
    Backward: the vjp of :func:`ssd_chunked`, recomputed from the saved
    inputs, which is the reference's own backward (JAX differentiates
    ``ssd_chunked``); a ``None`` cotangent of the final state counts as
    zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, chunk: int):
        from repro_torch.kernels.ssd_scan.ops import ssd_scan

        ctx.save_for_backward(x, dt, A, B_, C_)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd_scan(x, dt, A, B_, C_, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        pairs = [(i, g) for i, g in enumerate((gy, gstate)) if g is not None]
        if not pairs:
            return (None,) * (len(inputs) + 1)
        with span("ssd.backward"), torch.enable_grad():
            outs = ssd_chunked(*inputs, ctx.chunk)
            grads = iter(torch.autograd.grad([outs[i] for i, _ in pairs], wanted,
                                             [g for _, g in pairs], allow_unused=True))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def ssd_step(
    x: torch.Tensor,   # (B, nh, hd)
    dt: torch.Tensor,  # (B, nh)
    A: torch.Tensor,   # (nh,)
    B_: torch.Tensor,  # (B, ds)
    C_: torch.Tensor,  # (B, ds)
    state: torch.Tensor,  # (B, nh, hd, ds) f32
):
    """One decode step of the SSD recurrence; on DTensors on each rank's
    shards, the batch, heads and head dims kept split."""
    if sh.is_sharded(x, state):
        px = sh.keep_shards(x, (0, 1, 2))
        pb = sh.mapped(px, {0: 0})
        ps = sh.mapped(px, {0: 0, 1: 1, 2: 2})
        return sh.local_call(ssd_step, (x, dt, A, B_, C_, state),
                             (px, sh.mapped(px, {0: 0, 1: 1}), sh.mapped(px, {1: 0}), pb, pb, ps),
                             (px, ps))
    dt = dt.float()
    da = torch.exp(dt * A)  # (B, nh)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, B_.float(), x.float())
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C_.float(), state)
    return y.to(x.dtype), state


def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device=None):
    di, ds, nh, w = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
    return {
        "state": torch.zeros((batch, nh, cfg.ssm_head_dim, ds), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((batch, w - 1, di), dtype=dtype, device=device),
        "conv_b": torch.zeros((batch, w - 1, ds), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, w - 1, ds), dtype=dtype, device=device),
    }


def ssm_cache_logical(cfg):
    return {
        "state": ("batch", "ssm_heads", "ssm_hd", "ssm_state"),
        "conv_x": ("batch", None, "tp"),
        "conv_b": ("batch", None, None),
        "conv_c": ("batch", None, None),
    }


def ssm_mixer(
    params,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    return_cache: bool = False,
):
    """Full Mamba-2 mixer: proj -> conv -> SSD -> gated norm -> out proj.

    Train/prefill when cache is None (optionally returning the cache for
    serving); decode (S==1) when cache is given.  Returns (y, new_cache_or_None).
    """
    B, S, d = x.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32

    xp = constrain(dense(x, params["w_x"]), ("batch", "seq_full", "tp"))  # (B,S,di)
    z = constrain(dense(x, params["w_z"]), ("batch", "seq_full", "tp"))
    bp = constrain(dense(x, params["w_b"]), ("batch", "seq_full", None))  # (B,S,ds)
    cp = constrain(dense(x, params["w_c"]), ("batch", "seq_full", None))
    dt_raw = dense(x, params["w_dt"]).float()  # (B,S,nh)
    dt = softplus(dt_raw + params["dt_bias"].float())
    dt = constrain(dt, ("batch", "seq_full", "ssm_heads"))
    A = -torch.exp(params["a_log"].float())  # (nh,)

    if cache is None:
        xc = constrain(silu(_causal_conv(xp, params["conv_x"])), ("batch", "seq_full", "tp"))
        bc = silu(_causal_conv(bp, params["conv_b"]))
        cc = silu(_causal_conv(cp, params["conv_c"]))
        xh = constrain(sh.split_dim(xc, 2, (nh, hd)), ("batch", "seq_full", "ssm_heads", "ssm_hd"))
        chunk = cfg.ssm_chunk
        if cfg.use_kernels == "cuda":
            scan = lambda *a: SSDScan.apply(*a, chunk)  # noqa: E731
        elif cfg.use_kernels == "off":
            scan = lambda *a: ssd_chunked(*a, chunk)  # noqa: E731
        else:
            raise ValueError(f"use_kernels={cfg.use_kernels!r}, not 'off' or 'cuda'")
        y, final_state = on_shards(scan, xh, dt, A, bc, cc)
        y = y + params["d_skip"].float()[:, None] * xh.float()
        new_cache = None
        if return_cache:
            W = cfg.ssm_conv_width
            if S < W - 1:
                raise ValueError(f"ssm_mixer: a prompt of {S} tokens is shorter than the "
                                 f"conv window's {W - 1}")
            new_cache = {
                "state": final_state,
                "conv_x": xp[:, S - (W - 1):, :],
                "conv_b": bp[:, S - (W - 1):, :],
                "conv_c": cp[:, S - (W - 1):, :],
            }
    else:
        xc_t, conv_x = _conv_step(xp, cache["conv_x"], params["conv_x"])
        bc_t, conv_b = _conv_step(bp, cache["conv_b"], params["conv_b"])
        cc_t, conv_c = _conv_step(cp, cache["conv_c"], params["conv_c"])
        xh = sh.split_dim(silu(xc_t)[:, 0], 1, (nh, hd))
        yt, state = ssd_step(
            xh, dt[:, 0], A, silu(bc_t)[:, 0], silu(cc_t)[:, 0], cache["state"]
        )
        y = yt[:, None] + params["d_skip"].float()[:, None] * xh.float()[:, None]
        y = y.reshape(B, S, nh, hd)
        new_cache = {
            "state": state, "conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c
        }

    y = sh.merge_dims(y, 2, 2).to(x.dtype)
    y = constrain(y, ("batch", "seq_full", "tp"))
    y = rms_norm(y * silu(z), params["norm"], cfg.rmsnorm_eps, cfg.use_kernels)
    out = dense(y, params["w_out"])
    out = constrain(out, ("batch", "seq", "embed"))
    return out, new_cache
