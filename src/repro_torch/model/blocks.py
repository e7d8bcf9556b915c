"""Block assembly: pre-norm mixer (attention or SSD) + optional FFN (dense
SwiGLU or MoE) (port of ``repro/model/blocks.py``).

Every norm runs through ``layers.rms_norm`` in ``cfg.use_kernels`` mode; the
MoE FFN (``model/moe.py``) returns the block's aux losses.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import FFN_DENSE, FFN_NONE, MIXER_ATTN, BlockKind
from repro_torch.model.attention import attention, attn_defs
from repro_torch.model.layers import mlp_defs, norm_defs, rms_norm, swiglu
from repro_torch.model.moe import moe_defs, moe_ffn
from repro_torch.model.ssm import init_ssm_cache, ssm_cache_logical, ssm_defs, ssm_mixer


def block_defs(cfg, kind: BlockKind) -> Dict[str, Any]:
    d = cfg.d_model
    defs: Dict[str, Any] = {"norm_mixer": norm_defs(d)}
    defs["mixer"] = attn_defs(cfg) if kind.mixer == MIXER_ATTN else ssm_defs(cfg)
    if kind.ffn != FFN_NONE:
        defs["norm_ffn"] = norm_defs(d)
        defs["ffn"] = mlp_defs(d, cfg.d_ff) if kind.ffn == FFN_DENSE else moe_defs(cfg)
    return defs


def init_block_cache(cfg, kind: BlockKind, batch: int, cache_len: int, dtype,
                     device=None):
    """Decode cache for one block."""
    if kind.mixer == MIXER_ATTN:
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        return {
            "k": torch.zeros((batch, cache_len, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, cache_len, kv, hd), dtype=dtype, device=device),
        }
    return init_ssm_cache(cfg, batch, dtype, device)


def block_cache_logical(cfg, kind: BlockKind):
    if kind.mixer == MIXER_ATTN:
        ax = ("kv_batch", "kv_seq", "kv_heads", None)
        return {"k": ax, "v": ax}
    return ssm_cache_logical(cfg)


def block_fwd(
    params,
    x: torch.Tensor,
    kind: BlockKind,
    cfg,
    positions: torch.Tensor,
    *,
    cache=None,
    write_pos=None,
    window: int = 0,
    ring: bool = False,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Returns (x, new_cache, aux); aux is empty unless the FFN is MoE."""
    aux: Dict[str, torch.Tensor] = {}
    x, new_cache = block_mixer(
        params, x, kind, cfg, positions, cache=cache, write_pos=write_pos, window=window,
        ring=ring, return_cache=return_cache,
    )
    if kind.ffn != FFN_NONE:
        h = rms_norm(x, params["norm_ffn"]["scale"], cfg.rmsnorm_eps, cfg.use_kernels)
        if kind.ffn == FFN_DENSE:
            f = swiglu(h, params["ffn"]["w_gate"], params["ffn"]["w_up"],
                       params["ffn"]["w_down"])
        else:
            f, aux = moe_ffn(params["ffn"], h, cfg)
        x = x + f
    return x, new_cache, aux


def block_mixer(params, x: torch.Tensor, kind: BlockKind, cfg, positions: torch.Tensor, *,
                cache=None, write_pos=None, window: int = 0, ring: bool = False,
                return_cache: bool = False) -> Tuple[torch.Tensor, Any]:
    """The block's first half: ``x + mixer(norm(x))``.  Returns (x,
    new_cache)."""
    h = rms_norm(x, params["norm_mixer"]["scale"], cfg.rmsnorm_eps, cfg.use_kernels)
    if kind.mixer == MIXER_ATTN:
        y, new_cache = attention(
            params["mixer"], h, cfg, positions,
            cache=(cache["k"], cache["v"]) if cache is not None else None,
            write_pos=write_pos, window=window, ring=ring,
            return_cache=return_cache or cache is not None,
        )
        if new_cache is not None:
            new_cache = {"k": new_cache[0], "v": new_cache[1]}
    else:
        y, new_cache = ssm_mixer(
            params["mixer"], h, cfg, cache=cache,
            return_cache=return_cache or cache is not None,
        )
    return x + y, new_cache
