"""The ``dense`` family of the plain reference (SmolLM, the Llama
architecture): per block RMSNorm, grouped-query causal attention with rotary
embeddings (rotate-half, base ``rope_theta``), a residual, RMSNorm, a SwiGLU
MLP and a residual.  Its cache is the keys and values of every position.

The frame (``bench/reference/lm.py``) also runs this block as the leading
dense layers of any family (``first_k_dense``): their leaves are named as
this block's under the prefix ``layers/lead/`` in place of ``layers/pos0/``."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from bench.reference.lm import NEG_INF, STACK, family_layers, rms_norm
from bench.reference.precision import Precision


def param_spec(model: dict, prefix: str = STACK, layers: Optional[int] = None) -> list:
    """(path, shape, dtype, init, scale) of the block leaves under
    ``prefix``, stacked over ``layers`` (the family's stack unless given),
    after the mixer's norm."""
    d, pd = model["d_model"], model["param_dtype"]
    L = family_layers(model) if layers is None else layers
    H, kv, hd, ff = model["num_heads"], model["num_kv_heads"], model["head_dim"], model["d_ff"]
    m = prefix + "mixer/"
    return [(m + "wq", (L, d, H * hd), pd, "normal", None),
            (m + "wk", (L, d, kv * hd), pd, "normal", None),
            (m + "wv", (L, d, kv * hd), pd, "normal", None),
            (m + "wo", (L, H * hd, d), pd, "normal", None),
            (prefix + "norm_ffn/scale", (L, d), "float32", "ones", None),
            (prefix + "ffn/w_gate", (L, d, ff), pd, "normal", None),
            (prefix + "ffn/w_up", (L, d, ff), pd, "normal", None),
            (prefix + "ffn/w_down", (L, ff, d), pd, "normal", None)]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (b, S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv_freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv_freq
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(p: Dict[str, torch.Tensor], i: int, h: torch.Tensor, model: dict,
              prec: Precision, prefix: str = STACK):
    """Causal GQA attention of normed h (b, S, d) with layer i's weights
    under ``prefix``.  Returns (output (b, S, d), (k, v) each (b, S, kv, hd))."""
    b, S, _ = h.shape
    H, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    mm = prec.matmul
    m = prefix + "mixer/"
    q = rope(mm(h, p[m + "wq"][i]).reshape(b, S, H, hd), model["rope_theta"])
    k = rope(mm(h, p[m + "wk"][i]).reshape(b, S, kv, hd), model["rope_theta"])
    v = mm(h, p[m + "wv"][i]).reshape(b, S, kv, hd)
    G = H // kv
    qh = q.transpose(1, 2)                                    # (b, H, S, hd)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)        # query head j reads kv head j // G
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    scores = mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, NEG_INF), dim=-1)
    out = mm(probs, vh).transpose(1, 2).reshape(b, S, H * hd)
    return mm(out, p[m + "wo"][i]), (k, v)


def block(p: Dict[str, torch.Tensor], i: int, x: torch.Tensor, h: torch.Tensor, model: dict,
          prec: Precision, prefix: str = STACK):
    """Layer i under ``prefix`` on the residual x (b, S, d), h its
    mixer-normed input.  Returns (new residual, cache {k, v}, no loss
    readings)."""
    y, (k, v) = attention(p, i, h, model, prec, prefix)
    x = x + y
    h = rms_norm(x, p[prefix + "norm_ffn/scale"][i], model["rmsnorm_eps"])
    mm = prec.matmul
    f = mm(F.silu(mm(h, p[prefix + "ffn/w_gate"][i])) * mm(h, p[prefix + "ffn/w_up"][i]),
           p[prefix + "ffn/w_down"][i])
    return x + f, {"k": k, "v": v}, {}
