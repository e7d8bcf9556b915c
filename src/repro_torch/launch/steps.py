"""Step factories (port of ``repro/launch/steps.py``).

``make_train_step(cfg, opt, accum_steps)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``: the loss and its
gradients by autograd, optionally accumulated in float32 over microbatches,
then the AdamW update.  ``make_prefill_step(cfg)`` and
``make_decode_step(cfg)`` return the serving steps, ``lm.prefill`` and
``lm.decode_step`` under ``torch.inference_mode()`` (no gradient is recorded,
so the SSD scan kernel may run).  One card, no sharding constraints.  The
dry-run spec functions (``batch_specs``, ``cell_specs``, ...) wait for
``launch/dryrun``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.model import lm
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any
METRIC_KEYS = ("loss", "ce", "moe_balance", "moe_zloss", "tokens")


def _as_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    def put(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        return a.to(device)

    return {k: put(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt: OptConfig, accum_steps: int = 1):
    """Train step with optional gradient accumulation over microbatches.

    Accumulation bounds the activation working set (the per-microbatch
    forward/backward is the peak) while keeping the global batch semantics;
    gradients then accumulate in float32."""

    def loss_and_grads(params, batch):
        leaves, treedef = tree_flatten(params)
        loss, metrics = lm.lm_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, tree_unflatten(treedef, list(grads))

    def train_step(params, opt_state, batch):
        batch = _as_batch(batch, tree_leaves(params)[0].device)
        if accum_steps == 1:
            metrics, grads = loss_and_grads(params, batch)
        else:
            micro = {k: v.chunk(accum_steps, dim=0) for k, v in batch.items()}
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            m_sum = {k: 0.0 for k in METRIC_KEYS}
            for i in range(accum_steps):
                m, g = loss_and_grads(params, {k: v[i] for k, v in micro.items()})
                g_sum = tree_map(lambda a, b: a + b.float(), g_sum, g)
                m_sum = {k: m_sum[k] + m[k] for k in METRIC_KEYS}
            grads = tree_map(lambda g: g / accum_steps, g_sum)
            metrics = {k: v / accum_steps for k, v in m_sum.items()}
        new_params, new_opt, opt_metrics = adamw_update(params, grads, opt_state, opt)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return lm.prefill(params, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        with torch.inference_mode():
            return lm.decode_step(params, cfg, cache, tokens, pos)

    return serve_step
