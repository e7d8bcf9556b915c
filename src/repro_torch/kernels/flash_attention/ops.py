"""Public wrapper: shape plumbing, GQA folding and the differentiable flash
attention, as ``repro/kernels/flash_attention/ops.py``.

``flash_attention`` takes the reference's ``(B, S, H, hd)`` layout, folds
batch and heads into ``(B*H, S, hd)`` (and ``(B*KV, S, hd)`` for K/V, never
repeated in memory) and runs ``FlashAttention``, a ``torch.autograd.Function``
whose forward is the fwd kernel and whose backward is the dQ and dK/dV
kernels.  For CUDA tensors those are the CUDA kernels (``kernel.py``), which
raise on what they do not take; for CPU tensors, their plain versions
(``ref.py``).  Nothing falls back from one to the other.

On DTensors (a sharded step, ``distributed/sharding.py``) the op runs on each
rank's shards (``sharding.local_call``): batch and heads may stay sharded,
the sequence is gathered first; a head split that the kv heads do not
follow is gathered as well.

``model/attention.py`` sends training and prefill here (a prefill's cache
is the k and v it passes in).  Prompts may have any length, so a causal self-attention whose length
the tiles do not divide (``kernel.TILE`` on the card; ``block_q``/
``block_k`` on the CPU once the length exceeds them) runs padded with zero
rows at the end of q, k and v, and its output is cut back.  That is exact:
under the causal mask a real query row never sees a key after it, so never
a padded key, and the padded rows' outputs are dropped (their gradient is
zero).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel, ref


def flash_fwd(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              block_k: int = 128):
    """(o, lse) for folded q (B*H, Sq, hd), k/v (B*KV, Sk, hd)."""
    if q.device.type == "cuda":
        return kernel.flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
    return ref.flash_fwd_ref(q, k, v, causal=causal, scale=scale, block_k=block_k)


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = True,
              scale: Optional[float] = None, block_q: int = 128):
    """(dq, dk, dv); dk/dv per kv head, summed over its query-head group."""
    delta = ref.delta_of(o, do)
    if q.device.type == "cuda":
        dq = kernel.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal, scale=scale)
        dk, dv = kernel.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal, scale=scale)
        return dq, dk, dv
    kw = dict(causal=causal, scale=scale, block_q=block_q)
    dq = ref.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dk, dv = ref.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Folded flash attention: forward saves (q, k, v, o, lse); backward
    recomputes p from lse (no S x S matrix is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, block_q: int, block_k: int):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, scale, block_q)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, block_q = ctx.opts
        dq, dk, dv = flash_bwd(
            q, k, v, o, lse, do.contiguous(), causal=causal, scale=scale, block_q=block_q
        )
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, **kw) -> torch.Tensor:
    """Multi-head GQA flash attention, differentiable (:func:`flash_attention_local`
    on plain tensors, on each rank's shards for DTensors)."""
    from repro_torch.distributed import sharding as sh

    if not sh.is_sharded(q, k, v):
        return flash_attention_local(q, k, v, **kw)
    # batch and heads stay split where the kv heads can follow the split
    pq = sh.divisible(sh.keep_shards(q, (0, 2)), 2, k.shape[2], q.device_mesh)
    return sh.local_call(lambda q, k, v: flash_attention_local(q, k, v, **kw), (q, k, v),
                         (pq, pq, pq), pq)


def _causal_pad(q, S_q: int, S_k: int, causal: bool, block_q: int, block_k: int) -> int:
    """Zero rows to append to q, k and v so that the tiles divide a causal
    self-attention's length: up to a multiple of ``kernel.TILE`` on the card,
    of both blocks on the CPU once the length exceeds either.  0 for
    another attention, which the kernels take as it is or refuse."""
    if not causal or S_q != S_k:
        return 0
    if q.device.type == "cuda":
        tile = kernel.TILE
    else:
        tile = math.lcm(block_q, block_k) if S_q > min(block_q, block_k) else S_q
    return -S_q % tile


def flash_attention_local(
    q: torch.Tensor,  # (B, S_q, H, hd)
    k: torch.Tensor,  # (B, S_k, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Multi-head GQA flash attention, differentiable.  Returns (B, S_q, H, hd).

    ``block_q``/``block_k`` tile the plain version (CPU tensors) as the
    reference's kernel is tiled, and the sequence lengths must be multiples
    of them there; the CUDA kernels use their own tiles and check what they
    take (``kernel.check_inputs``).  A causal self-attention of another
    length runs padded at the end (``_causal_pad``)."""
    B, S_q, H, hd = q.shape
    _, S_k, KV, _ = k.shape
    pad = _causal_pad(q, S_q, S_k, causal, block_q, block_k)
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        out = flash_attention_local(q, k, v, causal=True, scale=scale, block_q=block_q,
                                    block_k=block_k)
        return out[:, :S_q]
    bq, bk = min(block_q, S_q), min(block_k, S_k)
    if q.device.type != "cuda" and (S_q % bq or S_k % bk):
        raise ValueError(f"flash_attention: S_q={S_q}, S_k={S_k} not multiples of blocks {bq}, {bk}")
    scale_v = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.transpose(1, 2).reshape(B * H, S_q, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * KV, S_k, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * KV, S_k, hd).contiguous()
    out = FlashAttention.apply(qf, kf, vf, causal, scale_v, bq, bk)
    return out.reshape(B, H, S_q, hd).transpose(1, 2)
