"""GQA attention: the q-chunked plain path, the flash-kernel path and the
single-token decode branch (port of ``repro/model/attention.py``), with the
reference's sharding constraints.

``cfg.use_kernels`` picks the train/prefill path when there is no window:

  * ``"cuda"`` — ``kernels.flash_attention.flash_attention``: the CUDA kernels
    on CUDA tensors, their plain versions on CPU tensors;
  * ``"off"``  — the chunked plain path: queries in chunks whose float32 score
    block stays under a budget, each chunk recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

A prefill (``return_cache=True``) takes the flash path as training does;
the reference takes its Pallas path only when no cache is to be returned.
The cache a prefill returns is the projected k and v on either path, which
the attention's output never touches, so both return the same cache.  A
head dim or dtype the kernels do not take fails in ``kernel.check_inputs``,
as in training.  A length the kernels' tile does not divide is padded at the
end and cut back (``flash_attention_local``), which is exact under the
causal mask: a real query row never sees a key after it, so never a padded
one.

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

Under a ``shard_ctx`` (``distributed/sharding.py``) the tensors are DTensors
and the constraints are the reference's: head parallel (``heads`` on the
model axis) or context parallel (``seq_q`` on it, ``_seq_shards``) as
``make_rules`` picks.  The attention itself runs on each rank's shards
(``sharding.local_call``): the flash kernels through their own boundary
(batch and heads kept, the sequence gathered); the chunked path with batch,
heads and, context parallel, the query sequence kept, each rank's rows
offset by its shard (``_attn_block_p``) and the keys gathered; the decode
writes the new key and value into the rank's own cache shard in place and
attends over that shard, a split ``kv_seq`` merging the softmax's max and
sum and the partial ``P.V`` products with all-reduces (the reference's
flash-decode), so the cache never moves.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain, current_ctx, replicate
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


def _axis_size(name: str) -> int:
    return sh.ctx_axis_size(name)


def _seq_shards(seq: int) -> int:
    """How many ways the query sequence is sharded (context-parallel strategy)."""
    ctx = current_ctx()
    if ctx is None:
        return 1
    if ctx.rules.get("seq_q") != "model":
        return 1
    m = _axis_size("model")
    return m if (m > 1 and seq % m == 0) else 1


def _pick_q_chunk(
    batch: int, heads: int, seq: int, local_seq: int, budget_bytes: int = 1 << 27
) -> int:
    """Largest power-of-two local q-chunk whose per-device score block fits budget."""
    b_sh = 1
    ctx = current_ctx()
    if ctx is not None:
        b_sh = _axis_size("data") * _axis_size("pod")
        if batch % b_sh:
            b_sh = 1
    h_sh = _axis_size("model") if (ctx and ctx.rules.get("heads") == "model") else 1
    if heads % h_sh:
        h_sh = 1
    per_row = (batch // b_sh) * (heads // h_sh) * seq * 4  # f32 scores
    chunk = max(128, int(budget_bytes // max(per_row, 1)))
    chunk = 1 << (chunk.bit_length() - 1)  # floor power of two
    while local_seq % chunk and chunk > 1:
        chunk //= 2
    return max(1, min(chunk, local_seq))


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


def _attn_block_p(q, k, v, rows, cols, window: int, scale: float, plain: bool):
    """Shard-structured block.  q: (B,P,Q,H,hd); rows: (P,Q) global query
    positions; k/v head-major (B,H,S,hd) -> (B,P,Q,H,hd).  P is the
    context-parallel dim: the query-sequence shards a rank holds, each with
    its own rows."""
    B, P, Q, H, hd = q.shape
    out = _attn_block(q.reshape(B, P * Q, H, hd), k, v, rows.reshape(-1), cols, window,
                      scale, plain)
    return out.reshape(B, P, Q, H, hd)


def _chunked(q, k, v, window: int, scale: float, plain: bool, row0: int, seq: int):
    """The chunked plain path on one rank's q (B, S_local, H, hd), whose rows
    start at ``row0``, and its full-sequence k/v (B, S, kv, hd)."""
    B, local, H, hd = q.shape
    G = H // k.shape[2]
    # the repeated K/V laid out head-major, once
    k_full = torch.repeat_interleave(k.transpose(1, 2), G, dim=1).contiguous()
    v_full = torch.repeat_interleave(v.transpose(1, 2), G, dim=1).contiguous()
    cols = torch.arange(k.shape[1], device=q.device)
    q_chunk = _pick_q_chunk(B, H, seq, local)

    def chunk_attn(qc, j):
        rows = row0 + j * q_chunk + torch.arange(q_chunk, device=q.device)
        return _attn_block_p(qc[:, None], k_full, v_full, rows[None], cols, window, scale,
                             plain)[:, 0]

    def run(qc, j):
        if not torch.is_grad_enabled():  # nothing to recompute
            return chunk_attn(qc, j)
        return checkpoint(chunk_attn, qc, j, use_reentrant=False, preserve_rng_state=False)

    outs = [run(q[:, j * q_chunk:(j + 1) * q_chunk], j) for j in range(local // q_chunk)]
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


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
    q = sh.split_dim(dense(x, params["wq"]), 2, (H, hd))
    k = sh.split_dim(dense(x, params["wk"]), 2, (kv, hd))
    v = sh.split_dim(dense(x, params["wv"]), 2, (kv, hd))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rmsnorm_eps, cfg.use_kernels)
        k = rms_norm(k, params["k_norm"], cfg.rmsnorm_eps, cfg.use_kernels)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)  # (S, hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def _kv_cache(k, v):
    """The cache a prefill returns: its projected k and v, in the decode
    cache's sharding."""
    return (constrain(k, ("kv_batch", "kv_seq", "kv_heads", None)),
            constrain(v, ("kv_batch", "kv_seq", "kv_heads", None)))


def _decode_scores(q, ck, wp, positions, window: int, ring: bool, cfg, scale: float,
                   offset: int = 0, S_max: Optional[int] = None):
    """Masked float32 scores (B, kv, G, S) of q (B, 1, H, hd) against the
    written cache (B, S, kv, hd), whose slots are the positions ``offset ...
    offset + S - 1`` of a cache of ``S_max`` slots (the whole cache by
    default): the reference's masks and scores."""
    B, _, H, hd = q.shape
    S, kv = ck.shape[1], ck.shape[2]
    G = H // kv
    S_max = S if S_max is None else S_max
    dev = ck.device
    multi = wp.dim() == 1
    cols = offset + torch.arange(S, dtype=torch.long, device=dev)
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
    scores = _cache_scores(q.reshape(B, kv, G, hd), ck, cfg.use_kernels == "off")
    if bf16_dots():  # the product emitted in the operands' type, then float32
        scores = scores.to(torch.promote_types(q.dtype, ck.dtype)).float()
    scores = scores * scale
    return torch.where(keep, scores, NEG_INF)


def _decode_core(q, ck, cv, wp, positions, window: int, ring: bool, cfg, scale: float):
    """Decode attention of q (B, 1, H, hd) over the written cache (B, S, kv,
    hd): float32 softmax, ``p`` rounded to the cache type.  Returns (B, kv,
    G, hd) in the cache's type."""
    scores = _decode_scores(q, ck, wp, positions, window, ring, cfg, scale)
    p = torch.softmax(scores, dim=-1).to(cv.dtype)
    return _cache_mix(p, cv, cfg.use_kernels == "off").to(cv.dtype)


def _decode_split(q, ck, cv, wp, positions, window: int, ring: bool, cfg, scale: float,
                  offset: int, S_max: int, groups):
    """``_decode_core`` over one rank's shard of a ``kv_seq``-split cache,
    holding slots ``offset ...``: the softmax's max and sum and the float32
    ``p.V`` partial products are all-reduced over ``groups`` (the split's
    process groups), as the reference's scores constrained to ``kv_seq``
    are: the cache itself never moves."""
    import torch.distributed as dist

    scores = _decode_scores(q, ck, wp, positions, window, ring, cfg, scale, offset, S_max)
    m = scores.amax(-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    e = torch.exp(scores - m)
    z = e.sum(-1, keepdim=True)
    for g in groups:
        dist.all_reduce(z, group=g)
    out = _cache_mix((e / z).to(cv.dtype), cv, cfg.use_kernels == "off")
    for g in groups:
        dist.all_reduce(out, group=g)
    return out.to(cv.dtype)


def _write_cache(ck, cv, k_new, v_new, wp, offset: Optional[int] = None):
    """Write the new key/value (B, 1, kv, hd) at ``wp`` (a scalar or (B,))
    into the cache IN PLACE; a cache shard holding positions ``offset ...
    offset + S - 1`` writes only the positions it holds."""
    if offset is None:  # the whole cache
        if wp.dim() == 1:
            rows = torch.arange(ck.shape[0], device=ck.device)
            ck[rows, wp] = k_new[:, 0].to(ck.dtype)
            cv[rows, wp] = v_new[:, 0].to(cv.dtype)
        else:
            ck.index_copy_(1, wp.reshape(1), k_new.to(ck.dtype))
            cv.index_copy_(1, wp.reshape(1), v_new.to(cv.dtype))
        return
    rows = torch.arange(ck.shape[0], device=ck.device)
    local = (wp - offset).expand(ck.shape[0])
    held = ((local >= 0) & (local < ck.shape[1]))[:, None, None]
    at = local.clamp(0, ck.shape[1] - 1)
    for c, new in ((ck, k_new), (cv, v_new)):
        c[rows, at] = torch.where(held, new[:, 0].to(c.dtype), c[rows, at])


def _decode_sharded(q, k_new, v_new, ck, cv, wp, positions, window, ring, cfg, scale):
    """The decode on each rank's shards: the new key/value into the rank's
    own cache shard in place, then attention over that shard (batch, kv-head
    and ``kv_seq`` splits kept; a ``kv_seq`` split merges its softmax with
    all-reduces, ``_decode_split``)."""
    mesh = ck.device_mesh
    pc = tuple(ck.placements)
    pn = sh.mapped(pc, {0: 0, 2: 2})  # batch and head splits of q, k, v, the cache
    multi = wp.dim() == 1
    pw = sh.mapped(pc, {0: 0}) if multi else (sh.Replicate(),) * mesh.ndim
    seq_dims = [i for i, p in enumerate(pc) if isinstance(p, sh.Shard) and p.dim == 1]

    def shard_offset(n_local: int) -> int:
        idx = 0
        for i in seq_dims:
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        return idx * n_local

    def write(ck_l, cv_l, k_l, v_l, wp_l):
        _write_cache(ck_l, cv_l, k_l, v_l, wp_l, offset=shard_offset(ck_l.shape[1]))
        return ck_l, cv_l

    def attend(q_l, ck_l, cv_l, wp_l, pos_l):
        if not seq_dims:
            return _decode_core(q_l, ck_l, cv_l, wp_l, pos_l, window, ring, cfg, scale)
        return _decode_split(q_l, ck_l, cv_l, wp_l, pos_l, window, ring, cfg, scale,
                             shard_offset(ck_l.shape[1]), ck.shape[1],
                             [mesh.get_group(i) for i in seq_dims])

    wp = replicate(wp)
    sh.local_call(write, (ck, cv, k_new, v_new, wp), (pc, pc, pn, pn, pw), (pc, pc))
    rep = (sh.Replicate(),) * mesh.ndim
    return sh.local_call(attend, (q, ck, cv, wp, replicate(positions)),
                         (pn, pc, pc, pw, rep), sh.mapped(pn, {0: 0, 2: 1}))


def _decode(params, q, k_new, v_new, cache, write_pos, positions, window: int,
            ring: bool, cfg, scale: float):
    """The decode branch (reference ``attention.py:163-221``); S == 1."""
    B, S, H, hd = q.shape
    ck, cv = cache
    wp = torch.as_tensor(write_pos, dtype=torch.long, device=ck.device)
    if sh.is_sharded(ck, cv):
        out = _decode_sharded(q, k_new, v_new, ck, cv, wp, positions, window, ring, cfg, scale)
    else:
        _write_cache(ck, cv, k_new, v_new, wp)
        out = _decode_core(q, ck, cv, wp, positions, window, ring, cfg, scale)
    y = dense(sh.merge_dims(out, 1, 3).reshape(B, S, H * hd), params["wo"])
    return constrain(y, ("batch", "seq", "embed")), (ck, cv)


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
    scale = 1.0 / math.sqrt(hd)

    q, k, v = _project_qkv(params, x, cfg, positions)
    if cache is not None:
        return _decode(params, q, k, v, cache, write_pos, positions, window, ring, cfg,
                       scale)
    if cfg.use_kernels != "off" and window == 0:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        out = flash_attention(q, k, v, causal=True)
        y = dense(sh.merge_dims(out, 2, 2), params["wo"])
        return constrain(y, ("batch", "seq", "embed")), (_kv_cache(k, v) if return_cache else None)

    q = constrain(q, ("batch", "seq_q", "heads", None))
    k = constrain(k, ("batch", "seq_full", "kv_heads", None))
    v = constrain(v, ("batch", "seq_full", "kv_heads", None))
    plain = cfg.use_kernels == "off"
    if sh.is_sharded(q, k, v):
        # Shard-aware chunking: each context-parallel shard (a rank along the
        # query split) runs its local chunks with its rows offset
        mesh = q.device_mesh
        P = _seq_shards(S)
        # a head split the kv heads cannot follow is gathered
        pq = sh.divisible(sh.keep_shards(q, (0, 1, 2) if P > 1 else (0, 2)), 2, kv, mesh)
        pk = sh.mapped(pq, {0: 0, 2: 2})
        seq_dims = [i for i, p in enumerate(pq) if isinstance(p, sh.Shard) and p.dim == 1]

        def local(q, k, v):
            idx = 0
            for i in seq_dims:
                idx = idx * mesh.size(i) + mesh.get_local_rank(i)
            return _chunked(q, k, v, window, scale, plain, idx * q.shape[1], S)

        # each query shard's share of dK/dV is a partial sum
        gk = sh.partial_where_split(pk, pq)
        out = sh.local_call(local, (q, k, v), (pq, pk, pk), pq, grad_placements=(pq, gk, gk))
    else:
        out = _chunked(q, k, v, window, scale, plain, 0, S)
    out = constrain(out, ("batch", "seq_q", "heads", None))
    out_flat = sh.merge_dims(out, 2, 2)
    ctx = current_ctx()
    if ctx is not None and ctx.rules.get("attn_out_seq"):
        # seq-sharded out-projection: a2a heads->seq, gather wo
        out_flat = constrain(out_flat, ("batch", "attn_out_seq", None))
    y = dense(out_flat, params["wo"])
    y = constrain(y, ("batch", "seq", "embed"))
    return y, (_kv_cache(k, v) if return_cache else None)
