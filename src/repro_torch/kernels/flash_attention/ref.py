"""Plain PyTorch versions of flash attention: the oracle the CUDA kernels are
held to on the card, and what ``ops.py`` runs for CPU tensors.

* ``attention_ref`` is the twin of ``repro/kernels/flash_attention/ref.py``:
  a full softmax over float32 scores.
* ``flash_fwd_ref``, ``flash_bwd_dq_ref`` and ``flash_bwd_dkv_ref`` follow the
  kernels' math and rounding points (``csrc/flash_attention.cu``): scores in
  float32, scaled after the product, masked to -1e30; an online softmax over
  key blocks of ``block_k`` with ``p`` rounded to the input type before P.V;
  ``lse`` in float32; the backward recomputes ``p = exp(s - lse)`` and uses
  ``delta = rowsum(dO * O)``; dK/dV are summed over each kv head's query-head
  group in float32 before the cast, as the dkv kernel does.  (The bfloat16
  kernels also round p and dS to bfloat16 as operands of their second
  products; this version keeps them in float32, as the reference does.)

Layout: q (B*H, Sq, hd), k/v (B*KV, Sk, hd); query head ``bh`` reads kv head
``bh // group``.  Products go through ``torch.matmul`` in float32 — this is the
plain version, never the kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _scale(scale: Optional[float], hd: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(hd)


def _expand(k: torch.Tensor, group: int) -> torch.Tensor:
    """(B*KV, S, hd) -> (B*KV*group, S, hd) float32, one copy per query head."""
    return k.float().repeat_interleave(group, dim=0)


def _masked(s: torch.Tensor, row0: int, col0: int, causal: bool) -> torch.Tensor:
    """Mask key col > query row (top-left aligned, as the kernels)."""
    if not causal:
        return s
    rows = torch.arange(row0, row0 + s.shape[-2], device=s.device)[:, None]
    cols = torch.arange(col0, col0 + s.shape[-1], device=s.device)[None, :]
    return s.masked_fill(cols > rows, NEG_INF)


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    group = BH // BKV
    s = torch.matmul(q.float(), _expand(k, group).transpose(1, 2)) * _scale(scale, hd)
    if causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, _expand(v, group)).to(q.dtype)


def flash_fwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: Optional[float] = None, block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q.dtype, lse float32 (BH, Sq)) by the kernels' online softmax."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    group = BH // BKV
    scale = _scale(scale, hd)
    bk = min(block_k, Sk)
    qf = q.float()
    kf, vf = _expand(k, group), _expand(v, group)
    m = torch.full((BH, Sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, Sq, hd), dtype=torch.float32, device=q.device)
    for j0 in range(0, Sk, bk):
        s = torch.matmul(qf, kf[:, j0:j0 + bk].transpose(1, 2)) * scale
        s = _masked(s, 0, j0, causal)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), vf[:, j0:j0 + bk])
        acc = acc * alpha + pv
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc).to(q.dtype), (m + torch.log(lc))[..., 0]


def _bwd_chunks(q, k, v, do, lse, delta, causal, scale, block_q):
    """Yield (i0, i1, q chunk, dO chunk, p, ds, k) in float32 over query
    chunks of ``block_q`` rows, every kv head expanded to its query heads."""
    BH, Sq, hd = q.shape
    group = BH // k.shape[0]
    scale = _scale(scale, hd)
    kf, vf = _expand(k, group), _expand(v, group)
    bq = min(block_q, Sq)
    for i0 in range(0, Sq, bq):
        i1 = i0 + bq
        qc, doc = q[:, i0:i1].float(), do[:, i0:i1].float()
        s = _masked(torch.matmul(qc, kf.transpose(1, 2)) * scale, i0, 0, causal)
        p = torch.exp(s - lse[:, i0:i1, None])
        dp = torch.matmul(doc, vf.transpose(1, 2))
        ds = p * (dp - delta[:, i0:i1, None]) * scale
        yield i0, i1, qc, doc, p, ds, kf


def flash_bwd_dq_ref(
    q, k, v, do, lse, delta, *, causal: bool = True,
    scale: Optional[float] = None, block_q: int = 128,
) -> torch.Tensor:
    dq = torch.empty_like(q)
    for i0, i1, _qc, _doc, _p, ds, kf in _bwd_chunks(
        q, k, v, do, lse, delta, causal, scale, block_q
    ):
        dq[:, i0:i1] = torch.matmul(ds, kf).to(q.dtype)
    return dq


def flash_bwd_dkv_ref(
    q, k, v, do, lse, delta, *, causal: bool = True,
    scale: Optional[float] = None, block_q: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    BH, _, hd = q.shape
    BKV, Sk, _ = k.shape
    dk = torch.zeros((BH, Sk, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for _i0, _i1, qc, doc, p, ds, _kf in _bwd_chunks(
        q, k, v, do, lse, delta, causal, scale, block_q
    ):
        dv += torch.matmul(p.transpose(1, 2), doc)
        dk += torch.matmul(ds.transpose(1, 2), qc)
    group = BH // BKV
    dk = dk.view(BKV, group, Sk, hd).sum(dim=1).to(k.dtype)
    dv = dv.view(BKV, group, Sk, hd).sum(dim=1).to(v.dtype)
    return dk, dv


def delta_of(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in float32, (BH, Sq): the backward's per-row constant."""
    return (do.float() * o.float()).sum(dim=-1)
