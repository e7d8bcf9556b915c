"""Causal LM assembly: embedding -> blocks -> chunked CE loss (port of
``repro/model/lm.py`` for training).

Layers are stacked per *period position*, as in the reference, so the two
packages share one parameter tree (``model/convert.py`` carries weights
across).  The forward unbinds each stacked leaf once and runs the blocks in a
Python loop (the reference's ``lax.scan``); with ``remat="block"`` each block
runs under ``torch.utils.checkpoint`` and is recomputed in the backward pass,
as under ``jax.checkpoint`` — the attention kernel's forward runs again there.

The CE loss is computed in 512-token sequence chunks, each recomputed in the
backward pass, with the head matmul inside, so the (tokens x vocab) float32
logits never exist for the whole sequence at once.

Not ported yet: ``batch_chunks > 1`` and the ``save_dispatch`` remat policy
(MoE only) raise; ``prefill``, ``decode_step`` and ``init_cache`` wait for the
LM serving slice (ROADMAP A8).
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.model.blocks import block_defs, block_fwd
from repro_torch.model.layers import (
    ParamDef,
    dense,
    init_params,
    norm_defs,
    rms_norm,
    stack_defs,
    torch_dtype,
)
from repro_torch.pytree import tree_flatten, tree_unflatten

PyTree = Any


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def model_defs(cfg: ModelConfig) -> PyTree:
    d, Vp = cfg.d_model, cfg.padded_vocab
    defs: Dict[str, Any] = {"embed": {"tok": ParamDef((Vp, d), ("vocab", "fsdp"))}}
    if cfg.frontend != "none":
        defs["frontend"] = {"proj": ParamDef((d, d), ("fsdp", "tp"))}
    defs["layers"] = {
        f"pos{i}": stack_defs(block_defs(cfg, kind), cfg.num_periods)
        for i, kind in enumerate(cfg.pattern())
    }
    defs["final_norm"] = norm_defs(d)
    if not cfg.tie_embeddings:
        defs["head"] = {"w": ParamDef((d, Vp), ("fsdp", "vocab"))}
    return defs


def init_model(cfg: ModelConfig, seed: int = 0,
               device: Union[str, torch.device] = "cpu") -> PyTree:
    return init_params(model_defs(cfg), seed, cfg.param_dtype, device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_in(params, cfg, tokens=None, embeds=None):
    dtype = torch_dtype(cfg.dtype)
    if embeds is not None:
        x = dense(embeds.to(dtype), params["frontend"]["proj"])
    else:
        x = F.embedding(tokens.long(), params["embed"]["tok"])
    return x.to(dtype)


def _head_w(params):
    if "head" in params:
        return params["head"]["w"]
    return params["embed"]["tok"].t()


def _vocab_mask(cfg, device=None) -> torch.Tensor:
    """(Vp,) additive mask: -1e30 on padded vocab entries."""
    idx = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(idx < cfg.vocab_size, 0.0, -1e30).float()


def _unstack(stacked: PyTree, n: int) -> List[PyTree]:
    """One tree per layer from a tree of (n, ...) leaves; each leaf is
    unbound once, so the backward writes each layer's gradient into one
    stacked gradient."""
    leaves, treedef = tree_flatten(stacked)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [u[i] for u in per_leaf]) for i in range(n)]


def forward_hidden(
    params, cfg: ModelConfig, tokens=None, embeds=None, *, collect_cache: bool = False
):
    """Full-sequence forward.  Returns (hidden (B,S,d), aux, None)."""
    if collect_cache:
        raise NotImplementedError(
            "collecting a decode cache (prefill) is not ported yet: ROADMAP A8, "
            "the LM serving slice"
        )
    if cfg.batch_chunks > 1:
        raise NotImplementedError(
            "batch_chunks > 1 (in-block batch chunking) is not ported: it only "
            "pays with sharded weights (ROADMAP A8, distributed)"
        )
    if cfg.remat not in ("block", "none"):
        raise NotImplementedError(f"remat policy {cfg.remat!r} is not ported (ROADMAP A8)")
    x = _embed_in(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    pattern = cfg.pattern()
    layers = {
        f"pos{i}": _unstack(params["layers"][f"pos{i}"], cfg.num_periods)
        for i in range(len(pattern))
    }

    def block(kind):
        def f(p, x):
            return block_fwd(p, x, kind, cfg, positions)[0]

        return f

    for period in range(cfg.num_periods):
        for i, kind in enumerate(pattern):
            p = layers[f"pos{i}"][period]
            if cfg.remat == "none":
                x = block(kind)(p, x)
            else:
                x = checkpoint(block(kind), p, x, use_reentrant=False,
                               preserve_rng_state=False)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"moe_balance": zero, "moe_zloss": zero}
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rmsnorm_eps)
    return x, aux, None


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _ce_chunk(h, labels, head_w, vmask):
    """(sum of token CE, count of valid tokens) over one sequence chunk."""
    logits = torch.matmul(h.float(), head_w.float()) + vmask
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((lse - lab) * valid), torch.sum(valid)


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """batch: {'tokens' | 'embeds', 'labels'} -> (loss, metrics)."""
    hidden, aux, _ = forward_hidden(params, cfg, batch.get("tokens"), batch.get("embeds"))
    labels = batch["labels"].long()
    B, S, d = hidden.shape
    head_w = _head_w(params)
    vmask = _vocab_mask(cfg, hidden.device)
    chunk = min(512, S)
    while S % chunk:
        chunk //= 2
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros_like(tot)
    for c0 in range(0, S, chunk):
        t, n = checkpoint(
            _ce_chunk, hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], head_w, vmask,
            use_reentrant=False, preserve_rng_state=False,
        )
        tot, cnt = tot + t, cnt + n
    ce = tot / cnt.clamp_min(1.0)
    n_layers = max(cfg.num_layers, 1)
    loss = (
        ce
        + cfg.router_aux_weight * aux["moe_balance"] / n_layers
        + 1e-3 * aux["moe_zloss"] / n_layers
    )
    metrics = {"loss": loss, "ce": ce, **aux, "tokens": cnt}
    return loss, metrics
