"""Step factories (port of ``repro/launch/steps.py``).

``make_train_step(cfg, opt, accum_steps)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``: the loss and its
gradients by autograd, optionally accumulated in float32 over microbatches,
then the AdamW update.  ``make_prefill_step(cfg)`` and
``make_decode_step(cfg)`` return the serving steps, ``lm.prefill`` and
``lm.decode_step`` under ``torch.inference_mode()`` (no gradient is recorded,
so the SSD scan kernel may run; ``no_grad`` inside a ``shard_ctx``).

Sharded steps run under ``shard_ctx(mesh, rules)`` with parameters and
optimizer state placed as DTensors; ``batch_specs``, ``params_specs`` and
``opt_specs`` give each argument's abstract form (meta-device tensors, the
reference's ``ShapeDtypeStruct``s) and logical axes, ``specs_to_pspecs``
their PartitionSpecs, as the reference's step placement reads them.  A
plain batch handed to a train step inside a context is placed by its
``batch_specs`` axes.  ``cache_specs`` gives the decode cache's,
``cell_specs(cfg, cell)`` the step of a shape cell with every argument's
form and axes (the dry-run traces it), and ``default_accum_steps`` the
reference's microbatching policy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed import sharding as sh
from repro_torch.model import lm
from repro_torch.model.layers import logical_axes as defs_logical
from repro_torch.model.layers import torch_dtype
from repro_torch.observability.spans import span
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any
METRIC_KEYS = ("loss", "ce", "moe_balance", "moe_zloss", "tokens")


BATCH_LOGICAL = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                 "embeds": ("batch", "seq", None)}


def default_accum_steps(cfg: ModelConfig, cell: ShapeCell) -> int:
    """Microbatching policy: keep the per-device microbatch around 2 rows."""
    if cell.kind != "train":
        return 1
    if cfg.accum_steps:
        return cfg.accum_steps
    if cfg.batch_chunks > 1:  # weight-stationary in-block chunking instead
        return 1
    n = max(1, cell.global_batch // 32)
    while cell.global_batch % n:
        n -= 1
    return min(n, 8)


def _as_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch on ``device``; inside a ``shard_ctx``, a plain leaf placed
    by its logical axes."""
    ctx = sh.current_ctx()

    def put(k, a):
        if isinstance(a, sh.DTensor):
            return a
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        a = a.to(device)
        if ctx is not None:
            a = sh.distribute_tensor(a, ctx.mesh, sh.ctx_placements(BATCH_LOGICAL[k], a.shape))
        return a

    return {k: put(k, v) for k, v in batch.items()}


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, sh.DTensor):
        return torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_train_step(cfg: ModelConfig, opt: OptConfig, accum_steps: int = 1):
    """Train step with optional gradient accumulation over microbatches.

    Accumulation bounds the activation working set (the per-microbatch
    forward/backward is the peak) while keeping the global batch semantics;
    gradients then accumulate in float32."""

    def loss_and_grads(params, batch):
        leaves, treedef = tree_flatten(params)
        with span("train.forward"):
            loss, metrics = lm.lm_loss(params, cfg, batch)
        # a leaf the loss does not reach (the token embedding of a model fed
        # embeddings) gets zeros, as jax.grad gives it
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, tree_unflatten(treedef, list(grads))

    def train_step(params, opt_state, batch):
        batch = _as_batch(batch, tree_leaves(params)[0].device)
        if accum_steps == 1:
            metrics, grads = loss_and_grads(params, batch)
        else:
            micro = {k: v.chunk(accum_steps, dim=0) for k, v in batch.items()}
            g_sum = tree_map(_zeros_f32, params)
            m_sum = {k: 0.0 for k in METRIC_KEYS}
            for i in range(accum_steps):
                m, g = loss_and_grads(params, {k: v[i] for k, v in micro.items()})
                g_sum = tree_map(lambda a, b: a + b.float(), g_sum, g)
                m_sum = {k: m_sum[k] + m[k] for k in METRIC_KEYS}
            grads = tree_map(lambda g: g / accum_steps, g_sum)
            metrics = {k: v / accum_steps for k, v in m_sum.items()}
        with span("train.optimizer"):
            new_params, new_opt, opt_metrics = adamw_update(params, grads, opt_state, opt)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step


def serving_mode():
    """``inference_mode`` on one device; ``no_grad`` inside a ``shard_ctx``
    (DTensor cannot wrap inference tensors)."""
    return torch.no_grad() if sh.current_ctx() is not None else torch.inference_mode()


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        with serving_mode():
            return lm.prefill(params, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        with serving_mode():
            return lm.decode_step(params, cfg, cache, tokens, pos)

    return serve_step


# ---------------------------------------------------------------------------
# Input specs (meta-device tensors + logical axes)
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Tuple[Dict, Dict]:
    """(meta tensor dict, logical-axes dict) for a train/prefill batch."""
    B, S = cell.global_batch, cell.seq_len
    meta = dict(device="meta")
    specs: Dict[str, Any] = {}
    logical: Dict[str, Any] = {}
    if cfg.frontend == "none":
        specs["tokens"] = torch.empty((B, S), dtype=torch.int32, **meta)
        logical["tokens"] = BATCH_LOGICAL["tokens"]
    else:
        specs["embeds"] = torch.empty((B, S, cfg.d_model), dtype=torch_dtype(cfg.dtype), **meta)
        logical["embeds"] = BATCH_LOGICAL["embeds"]
    if cell.kind == "train":
        specs["labels"] = torch.empty((B, S), dtype=torch.int32, **meta)
        logical["labels"] = BATCH_LOGICAL["labels"]
    return specs, logical


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Tuple[PyTree, PyTree]:
    """(meta tensor tree, logical-axes tree) of ``lm.init_cache``."""
    return lm.init_cache(cfg, batch, max_len, device="meta"), lm.cache_logical(cfg)


def params_specs(cfg: ModelConfig) -> Tuple[PyTree, PyTree]:
    defs = lm.model_defs(cfg)
    return lm.abstract_model(cfg), defs_logical(defs)


def opt_specs(cfg: ModelConfig, opt: OptConfig) -> Tuple[PyTree, PyTree]:
    abstract = init_opt_state(lm.abstract_model(cfg), opt)
    plog = defs_logical(lm.model_defs(cfg))
    logical = {
        "m": plog,
        "v": plog,
        "step": (),
    }
    if opt.keep_master:
        logical["master"] = plog
    return abstract, logical


def cell_specs(cfg: ModelConfig, cell: ShapeCell, opt: Optional[OptConfig] = None):
    """All (args, logical) for the step a cell runs.

    Returns (step_fn, args_specs_tuple, args_logical_tuple).  A train
    cell's parameters require grad, as the trainer's do."""
    opt = opt or OptConfig()
    p_spec, p_log = params_specs(cfg)
    if cell.kind == "train":
        p_spec = tree_map(lambda p: p.requires_grad_(p.is_floating_point()), p_spec)
        b_spec, b_log = batch_specs(cfg, cell)
        o_spec, o_log = opt_specs(cfg, opt)
        step = make_train_step(cfg, opt, default_accum_steps(cfg, cell))
        return step, (p_spec, o_spec, b_spec), (p_log, o_log, b_log)
    if cell.kind == "prefill":
        b_spec, b_log = batch_specs(cfg, cell)
        return make_prefill_step(cfg), (p_spec, b_spec), (p_log, b_log)
    # decode: one new token against a cache of seq_len
    c_spec, c_log = cache_specs(cfg, cell.global_batch, cell.seq_len)
    tok = torch.empty((cell.global_batch,), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return (
        make_decode_step(cfg),
        (p_spec, c_spec, tok, pos),
        (p_log, c_log, ("batch",), ()),
    )


def specs_to_pspecs(specs: PyTree, logical: PyTree, mesh, rules) -> PyTree:
    """Map (meta tensor tree, logical tree) -> PartitionSpec tree."""
    leaves, treedef = tree_flatten(specs)
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in x)
    axes = tree_flatten(logical, is_leaf=is_axes)[0]
    assert len(axes) == len(leaves), (len(axes), len(leaves))
    return tree_unflatten(treedef, [sh.make_pspec(lg, s.shape, mesh, rules)
                                    for s, lg in zip(leaves, axes)])
