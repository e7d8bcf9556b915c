"""GQA attention: the q-chunked plain path, the flash-kernel path and the
single-token decode branch (port of ``repro/model/attention.py``, one card, no
sharding rules).

``cfg.use_kernels`` picks the train/prefill path, under the reference's
condition for its Pallas path (no window, no cache to return):

  * ``"cuda"`` — ``kernels.flash_attention.flash_attention``: the CUDA kernels
    on CUDA tensors, their plain versions on CPU tensors;
  * ``"off"``  — the chunked plain path: queries in chunks whose float32 score
    block stays under a budget, each chunk recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

Decode (a cache given) is the reference's plain branch: scalar or per-slot
``(B,)`` write positions, the window mask and the ring cache, float32 scores
and ``p`` rounded to the cache type before ``P.V``.  With the reference's
experiment switch ``REPRO_BF16_DOTS=1`` (``layers.bf16_dots``) the scores
are rounded to the operands' type before the float32 softmax, as its QK
einsum then emits bf16.

The products of the decode and of the chunked path keep their bf16 operands
and come out in float32, as the reference's ``preferred_element_type=
float32`` does (``_bmm_f32``): on the card, where autograd records
nothing, ``torch.bmm(..., out_dtype=torch.float32)`` reads the cache as it
lies, with no float32 copy.  CPU tensors, autograd and ``use_kernels="off"``
cast the operands to float32 first, which computes the same products.  The
new key and value are written into the given cache tensors IN PLACE (the
reference returns updated copies), which saves a copy of the cache per layer
and step; the same tensors are returned.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.model.layers import (
    ParamDef,
    apply_rope,
    bf16_dots,
    dense,
    rms_norm,
    rope_angles,
)

NEG_INF = -1e30
KERNEL_MODES = ("off", "cuda")


def attn_defs(cfg) -> Dict[str, ParamDef]:
    d, H, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, H * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, kv * hd), ("fsdp", "tp")),
        "wv": ParamDef((d, kv * hd), ("fsdp", "tp")),
        "wo": ParamDef((H * hd, d), ("tp", "fsdp")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones", dtype="float32")
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones", dtype="float32")
    return defs


def _pick_q_chunk(batch: int, heads: int, seq: int, budget_bytes: int = 1 << 27) -> int:
    """Largest power-of-two q-chunk whose float32 score block fits the budget."""
    per_row = batch * heads * seq * 4
    chunk = max(128, int(budget_bytes // max(per_row, 1)))
    chunk = 1 << (chunk.bit_length() - 1)  # floor power of two
    while seq % chunk and chunk > 1:
        chunk //= 2
    return max(1, min(chunk, seq))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor, plain: bool) -> torch.Tensor:
    """Batched ``a @ b`` with a float32 result, the reference's
    ``preferred_element_type=float32``.  Half-precision operands on the card,
    unless autograd records them or ``plain`` is set, go to ``torch.bmm(...,
    out_dtype=torch.float32)``, which reads them as they lie.  Otherwise the
    operands are cast to float32 first, which computes the same product: CPU
    tensors (that call has no CPU kernel), autograd (it has no derivative)
    and ``use_kernels="off"`` (the plain reference the kernel path is held
    to)."""
    graded = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if (a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float16)
            and not plain and not graded):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _attn_block(q, k, v, rows, cols, window: int, scale: float, plain: bool):
    """q: (B,Q,H,hd); k/v head-major (B,H,S,hd); rows (Q,), cols (S,) ->
    (B,Q,H,hd)."""
    B, Q, H, hd = q.shape
    S = k.shape[2]
    qh = q.transpose(1, 2).reshape(B * H, Q, hd)
    scores = _bmm_f32(qh, k.view(B * H, S, hd).transpose(1, 2), plain).view(B, H, Q, S) * scale
    keep = cols[None, :] <= rows[:, None]
    if window:
        keep &= cols[None, :] > rows[:, None] - window
    scores = scores.masked_fill(~keep[None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = _bmm_f32(p.view(B * H, Q, S), v.view(B * H, S, hd), plain)
    return out.view(B, H, Q, hd).transpose(1, 2).to(v.dtype)


def _cache_scores(q_g, ck, plain: bool):
    """``einsum("bkgd,bskd->bkgs")`` in float32, reading the (B, S, kv, hd)
    cache as it lies: one product over every (kv head, key slot) pair of a
    batch row, of which the diagonal kv blocks are kept."""
    B, kv, G, hd = q_g.shape
    S = ck.shape[1]
    full = _bmm_f32(q_g.reshape(B, kv * G, hd), ck.view(B, S * kv, hd).transpose(1, 2), plain)
    return full.view(B, kv, G, S, kv).diagonal(dim1=1, dim2=4).permute(0, 3, 1, 2)


def _cache_mix(p, cv, plain: bool):
    """``einsum("bkgs,bskd->bkgd")`` in float32 from p (B, kv, G, S) and the
    (B, S, kv, hd) cache as it lies: p spread block-diagonally over (key
    slot, kv head), so other heads' values are multiplied by zeros."""
    B, kv, G, S = p.shape
    hd = cv.shape[-1]
    blocks = p.new_zeros(B, kv, G, S, kv)
    blocks.diagonal(dim1=1, dim2=4).copy_(p.permute(0, 2, 3, 1))
    out = _bmm_f32(blocks.view(B, kv * G, S * kv), cv.view(B, S * kv, hd), plain)
    return out.view(B, kv, G, hd)


def _project_qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, params["wq"]).reshape(B, S, H, hd)
    k = dense(x, params["wk"]).reshape(B, S, kv, hd)
    v = dense(x, params["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rmsnorm_eps, cfg.use_kernels)
        k = rms_norm(k, params["k_norm"], cfg.rmsnorm_eps, cfg.use_kernels)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)  # (S, hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def _decode(params, q, k_new, v_new, cache, write_pos, positions, window: int,
            ring: bool, cfg, scale: float):
    """The decode branch (reference ``attention.py:163-221``); S == 1."""
    B, S = q.shape[:2]
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // kv
    ck, cv = cache
    S_max = ck.shape[1]
    dev = ck.device
    wp = torch.as_tensor(write_pos, dtype=torch.long, device=dev)
    multi = wp.dim() == 1
    cols = torch.arange(S_max, dtype=torch.long, device=dev)
    if multi:
        rows = torch.arange(B, device=dev)
        ck[rows, wp] = k_new[:, 0].to(ck.dtype)
        cv[rows, wp] = v_new[:, 0].to(cv.dtype)
    else:
        ck.index_copy_(1, wp.reshape(1), k_new.to(ck.dtype))
        cv.index_copy_(1, wp.reshape(1), v_new.to(cv.dtype))
    pos = None if multi else positions.reshape(-1)[0].to(device=dev, dtype=torch.long)
    if ring:
        # Ring-buffer window cache: once full (pos >= S_max) every slot is a
        # valid in-window key; before that, only slots <= pos are.
        if multi:
            raise ValueError("ring window caches use uniform positions")
        cols = torch.where(pos >= S_max, pos, cols)
    if multi:
        keep = cols[None, :] <= wp[:, None]  # (B, S)
        if window:
            keep &= cols[None, :] > wp[:, None] - window
        keep = keep[:, None, None, :]
    else:
        keep = cols <= pos
        if window and not ring:
            keep &= cols > pos - window
        keep = keep[None, None, None, :]
    plain = cfg.use_kernels == "off"
    scores = _cache_scores(q.reshape(B, kv, G, hd), ck, plain)
    if bf16_dots():  # the product emitted in the operands' type, then float32
        scores = scores.to(torch.promote_types(q.dtype, ck.dtype)).float()
    scores = scores * scale
    scores = torch.where(keep, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = _cache_mix(p, cv, plain).to(cv.dtype)
    y = dense(out.reshape(B, S, H * hd), params["wo"])
    return y, (ck, cv)


def attention(
    params,
    x: torch.Tensor,
    cfg,
    positions: torch.Tensor,
    *,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    write_pos: Optional[torch.Tensor] = None,
    window: int = 0,
    ring: bool = False,
    return_cache: bool = False,
):
    """x: (B, S, d).  Train/prefill when cache is None; single-token decode
    otherwise.

    cache: (k, v) each (B, S_max, kv, hd); write_pos: a scalar position (int
    or 0-d tensor) or a (B,) vector (continuous batching: every slot at its own
    offset).  Returns (y, (k, v) if return_cache or decoding else None).
    """
    if cfg.use_kernels not in KERNEL_MODES:
        raise ValueError(f"use_kernels={cfg.use_kernels!r}, not one of {KERNEL_MODES}")
    B, S, d = x.shape
    H, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // kv
    scale = 1.0 / math.sqrt(hd)

    q, k, v = _project_qkv(params, x, cfg, positions)
    if cache is not None:
        return _decode(params, q, k, v, cache, write_pos, positions, window, ring, cfg,
                       scale)
    if cfg.use_kernels != "off" and window == 0 and not return_cache:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        out = flash_attention(q, k, v, causal=True)
        return dense(out.reshape(B, S, H * hd), params["wo"]), None

    # the repeated K/V laid out head-major, once
    k_full = torch.repeat_interleave(k.transpose(1, 2), G, dim=1).contiguous()
    v_full = torch.repeat_interleave(v.transpose(1, 2), G, dim=1).contiguous()
    plain = cfg.use_kernels == "off"
    cols = torch.arange(S, device=x.device)
    q_chunk = _pick_q_chunk(B, H, S)

    def chunk_attn(qc, j):
        rows = j * q_chunk + torch.arange(q_chunk, device=x.device)
        return _attn_block(qc, k_full, v_full, rows, cols, window, scale, plain)

    def run(qc, j):
        if not torch.is_grad_enabled():  # nothing to recompute
            return chunk_attn(qc, j)
        return checkpoint(chunk_attn, qc, j, use_reentrant=False, preserve_rng_state=False)

    outs = [run(q[:, j * q_chunk:(j + 1) * q_chunk], j) for j in range(S // q_chunk)]
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    y = dense(out.reshape(B, S, H * hd), params["wo"])
    return y, ((k, v) if return_cache else None)
