"""Causal LM assembly: embedding -> blocks -> chunked CE loss, and serving:
``init_cache``, ``prefill`` and ``decode_step`` (port of ``repro/model/lm.py``).

Layers are stacked per *period position*, as in the reference, so the two
packages share one parameter tree (``model/convert.py`` carries weights
across).  The forward unbinds each stacked leaf once and runs the blocks in a
Python loop (the reference's ``lax.scan``); with ``remat="block"`` each block
runs under ``torch.utils.checkpoint`` and is recomputed in the backward pass,
as under ``jax.checkpoint`` — the kernels' forwards run again there.  With
``remat="save_dispatch"`` an MoE block runs as two checkpoints, up to the
expert buffer and from it, so that the buffer is saved and the mixer, the
experts and the combine are recomputed, as under the reference's
``save_only_these_names("moe_dispatch")``.  Every output of the first
checkpoint is an input of the second and is saved as well: beside the
buffer, the post-mixer residual, the normed activations and the route
(two (tokens, d) tensors and the route's small ones a layer, where the
reference saves the buffer alone).  The checkpoints are non-reentrant, so
the autograd graph is the same under both policies and so are the
gradients, bit for bit; other blocks take ``"block"``.

The CE loss is computed in 512-token sequence chunks, each recomputed in the
backward pass, with the head matmul inside, so the (tokens x vocab) float32
logits never exist for the whole sequence at once.  The head product keeps
half-precision operands on the card and accumulates into a float32 result
(``head_logits``), as the reference's ``preferred_element_type=float32``
dot; its backward keeps the float32 products of the float32 cotangent.

Serving keeps the decode cache stacked per period position, as the
parameters are: a tree of ``(num_periods, ...)`` leaves per pattern position.
``prefill`` runs ``forward_hidden(collect_cache=True)`` (no recompute; the
attention blocks take the plain path, since they return a cache) and stacks
each block's cache.  ``decode_step`` updates the cache it is given IN PLACE
and returns it (the reference returns an updated copy): the attention blocks
write the new key/value into their slices, and the SSM blocks' new state and
conv windows are copied into theirs.

The forward sums the MoE blocks' aux losses (load balance, router z-loss)
per period and then over periods, as the reference's ``_acc_aux`` and scan
do, in every branch (collecting caches, without gradients, recomputed).

``cfg.batch_chunks > 1`` runs each block over the batch in that many chunks,
one after another inside the block (the reference's ``f_chunked``: its
weight gathers then happen once a block, not once a chunk), summing the
chunks' aux losses; under ``remat="block"`` the whole chunked block is one
checkpoint, under ``"save_dispatch"`` an MoE block's chunks each run as the
two checkpoints above.  It does not apply while collecting caches.

Under a ``shard_ctx`` (``distributed/sharding.py``) parameters and batch are
DTensors; the embedding, the blocks' outputs, the CE chunks and the serving
logits carry the reference's constraints, the CE runs over sequence-sharded
chunks (one (B, P, chunk) slice of every sequence shard at a time), and the
tensors made inside the step (positions, the vocabulary mask, the aux
zeros) enter the mesh replicated.  The stacked layers are unbound on the
``layers`` axis, which is never sharded.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import FFN_MOE, ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain, replicate
from repro_torch.model.blocks import (
    block_cache_logical,
    block_defs,
    block_fwd,
    block_mixer,
    init_block_cache,
)
from repro_torch.model.layers import (
    ParamDef,
    abstract_params,
    dense,
    init_params,
    norm_defs,
    resolve_device,
    rms_norm,
    stack_defs,
    torch_dtype,
)
from repro_torch.model.moe import _seq_shards, moe_combine, moe_dispatch
from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

PyTree = Any
REMAT_POLICIES = ("block", "none", "save_dispatch")


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
               device: Union[None, str, torch.device] = None) -> PyTree:
    """Random parameters from ``seed`` on ``device`` (``None``: ``cuda:0``,
    raising without CUDA)."""
    return init_params(model_defs(cfg), seed, cfg.param_dtype,
                       resolve_device(device, "init_model"))


def abstract_model(cfg: ModelConfig) -> PyTree:
    """Meta-device tensors of every parameter's shape and dtype."""
    return abstract_params(model_defs(cfg), cfg.param_dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_in(params, cfg, tokens=None, embeds=None):
    dtype = torch_dtype(cfg.dtype)
    if embeds is not None:
        x = dense(embeds.to(dtype), params["frontend"]["proj"])
    else:
        x = F.embedding(tokens.long(), params["embed"]["tok"])
    return constrain(x.to(dtype), ("batch", "seq", "embed"))


def _head_w(params):
    if "head" in params:
        return params["head"]["w"]
    return params["embed"]["tok"].t()


def _vocab_mask(cfg, device=None) -> torch.Tensor:
    """(Vp,) additive mask: -1e30 on padded vocab entries."""
    idx = torch.arange(cfg.padded_vocab, device=device)
    return replicate(torch.where(idx < cfg.vocab_size, 0.0, -1e30).float())


AUX_KEYS = ("moe_balance", "moe_zloss")


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: replicate(torch.zeros((), dtype=torch.float32, device=device)) for k in AUX_KEYS}


def _acc_aux(tot, aux):
    if not aux:
        return tot
    return {k: tot[k] + aux[k] for k in tot}


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
    """Full-sequence forward.  Returns (hidden (B,S,d), aux, cache_or_None)."""
    if cfg.remat not in REMAT_POLICIES:
        raise NotImplementedError(f"remat policy {cfg.remat!r} is not one of {REMAT_POLICIES}")
    x = _embed_in(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    positions = replicate(torch.arange(S, dtype=torch.int32, device=x.device))
    pattern = cfg.pattern()
    layers = {
        f"pos{i}": _unstack(params["layers"][f"pos{i}"], cfg.num_periods)
        for i in range(len(pattern))
    }

    def block(kind):
        def f(p, x):
            x, _, aux = block_fwd(p, x, kind, cfg, positions)
            return constrain(x, ("batch", "seq", "embed")), aux

        return f

    def dispatch(kind):
        # block_fwd of an MoE block up to the expert buffer, then from it
        def f(p, x):
            x, _ = block_mixer(p, x, kind, cfg, positions)
            h = rms_norm(x, p["norm_ffn"]["scale"], cfg.rmsnorm_eps, cfg.use_kernels)
            buf, route, aux = moe_dispatch(p["ffn"], h, cfg)
            return x, h, buf, route, aux

        return f

    def combine(p, x, h, buf, route):
        return constrain(x + moe_combine(p["ffn"], h, buf, route, cfg), ("batch", "seq", "embed"))

    def ckpt(fn, *args):
        # the recompute runs under this forward's shard context
        return checkpoint(sh.bind(fn), *args, use_reentrant=False, preserve_rng_state=False)

    def run(kind, p, x):
        """One block of one batch chunk under the remat policy; the chunked
        block under ``"block"`` is checkpointed whole by the caller."""
        if cfg.remat == "none" or not torch.is_grad_enabled():
            return block(kind)(p, x)
        if cfg.remat == "save_dispatch" and kind.ffn == FFN_MOE:
            # two checkpoints: the buffer between them is saved, and with
            # it the residual, the normed h and the route
            x, h, buf, route, aux = ckpt(dispatch(kind), p, x)
            return ckpt(combine, p, x, h, buf, route), aux
        return ckpt(block(kind), p, x)

    nb = cfg.batch_chunks
    if B % nb:
        raise ValueError(f"batch_chunks={nb} does not divide the batch {B}")

    def chunked(kind, inner):
        # weight-stationary accumulation: the batch chunks run one after
        # another inside the block, and their aux losses are summed
        def f(p, x):
            xc = constrain(x.reshape(nb, B // nb, *x.shape[1:]), (None, "batch", "seq", "embed"))
            ys, auxs = zip(*(inner(kind, p, xc[i]) for i in range(nb)))
            y = constrain(torch.stack(ys).reshape(x.shape), ("batch", "seq", "embed"))
            return y, {k: torch.sum(torch.stack([a[k] for a in auxs]), dim=0)
                       for k in auxs[0]}

        return f

    def one_block(kind, p, x):
        if nb <= 1:
            return run(kind, p, x)
        if cfg.remat == "block" and torch.is_grad_enabled():
            plain = lambda kind, p, x: block(kind)(p, x)  # noqa: E731
            return ckpt(chunked(kind, plain), p, x)
        return chunked(kind, run)(p, x)

    caches: Dict[str, List[Any]] = {f"pos{i}": [] for i in range(len(pattern))}
    period_aux = []
    for period in range(cfg.num_periods):
        aux_tot = _zero_aux(x.device)
        for i, kind in enumerate(pattern):
            p = layers[f"pos{i}"][period]
            if collect_cache:
                x, cache, aux = block_fwd(p, x, kind, cfg, positions, return_cache=True)
                x = constrain(x, ("batch", "seq", "embed"))
                caches[f"pos{i}"].append(cache)
            else:
                x, aux = one_block(kind, p, x)
            aux_tot = _acc_aux(aux_tot, aux)
        period_aux.append(aux_tot)
    aux = {k: torch.sum(torch.stack([a[k] for a in period_aux]), dim=0) for k in AUX_KEYS}
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rmsnorm_eps, cfg.use_kernels)
    if not collect_cache:
        return x, aux, None
    stacked = {k: _stack(per_layer) for k, per_layer in caches.items()}
    return x, aux, stacked


def _stack(trees: List[PyTree]) -> PyTree:
    """One tree of (n, ...) leaves from n trees of one structure."""
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    return tree_unflatten(treedef, [torch.stack(ls) for ls in zip(*(f[0] for f in flat))])


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _head_bwd(h, w, g):
    """The head product's gradients from the float32 cotangent ``g``: float32
    products of it, each rounded once to its operand's type (what JAX's
    transpose of the float32-accumulated dot computes)."""
    dh = torch.matmul(g, w.float().t()).to(h.dtype)
    dw = torch.matmul(h.float().t(), g).to(w.dtype)
    return dh, dw


class _HeadF32(torch.autograd.Function):
    """``h (R, d) @ w (d, V)`` with a float32 result from half-precision
    operands read as they lie (``torch.mm(..., out_dtype=float32)``, CUDA
    only); the backward is :func:`_head_bwd`."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        return _head_bwd(*ctx.saved_tensors, g)


def head_logits(h: torch.Tensor, w: torch.Tensor, kernels: str) -> torch.Tensor:
    """``(..., d) x (d, Vp)`` -> float32 logits, the reference's dot with
    ``preferred_element_type=float32``.  Half-precision CUDA operands under
    ``kernels != "off"`` go through :class:`_HeadF32`; CPU tensors (the call
    has no CPU kernel), float32 and ``"off"`` cast to float32 first, which
    computes the same product.

    On DTensors it runs on each rank's shards (``sharding.contract``): h's
    rows and w's vocabulary columns may stay split, each gradient a partial
    sum over the other's split."""
    if sh.is_sharded(h, w):
        return sh.contract(lambda h, w: head_logits(h, w, kernels), h, w)
    if h.is_cuda and h.dtype == w.dtype and h.dtype in (torch.bfloat16, torch.float16) \
            and kernels != "off":
        return _HeadF32.apply(h.reshape(-1, h.shape[-1]), w).reshape(*h.shape[:-1], -1)
    return torch.matmul(h.float(), w.float())


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim, its forward and backward
    written as the reductions and elementwise ops ATen's own are made of (the
    same values, bit for bit): on a DTensor split along that dim they keep
    the split, where DTensor's rule for ``logsumexp`` gathers the operand."""

    @staticmethod
    def forward(ctx, x):
        m = torch.amax(x, dim=-1, keepdim=True)
        m = m.masked_fill(m.abs() == float("inf"), 0)
        lse = torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None])


def _label_logit(logits, idx, vocab):
    """``logits[..., idx]`` as a masked sum over the last dim, whose global
    indices are ``vocab`` (the same value and gradient as a gather)."""
    return torch.sum(torch.where(vocab == idx[..., None], logits, 0.0), dim=-1)


def _ce_chunk(h, labels, head_w, vmask, kernels):
    """(sum of token CE, count of valid tokens) over one sequence chunk."""
    logits = constrain(head_logits(h, head_w, kernels) + vmask, ("batch", None, None, "vocab"))
    idx = labels.clamp_min(0)
    if sh.is_sharded(logits):
        # reductions over the vocabulary, which stays split (the same values
        # and gradients): DTensor's logsumexp gathers the logits, and a
        # gather's backward makes a zeros tensor of their global shape on
        # every rank
        lse = _LogSumExp.apply(logits)
        last = logits.dim() - 1
        pl = logits.placements
        pi = sh.mapped(pl, {d: d for d in range(last)})
        out = tuple(sh.Partial() if isinstance(p, sh.Shard) and p.dim == last else q
                    for p, q in zip(pl, pi))
        vocab = replicate(torch.arange(logits.shape[-1], device=idx.to_local().device))
        lab = sh.local_call(_label_logit, (logits, idx, vocab),
                            (pl, pi, sh.mapped(pl, {last: 0})), out)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, idx[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((lse - lab) * valid), torch.sum(valid)


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """batch: {'tokens' | 'embeds', 'labels'} -> (loss, metrics)."""
    hidden, aux, _ = forward_hidden(params, cfg, batch.get("tokens"), batch.get("embeds"))
    labels = batch["labels"].long()
    B, S, d = hidden.shape
    head_w = _head_w(params)
    vmask = _vocab_mask(cfg, hidden.device)
    # chunk the CE along the *local* sequence: one (B, P, chunk) slice of
    # every sequence shard at a time
    P = _seq_shards(S)
    Sp = S // P
    chunk = min(512, Sp)
    while Sp % chunk:
        chunk //= 2
    nc = Sp // chunk
    h_r = constrain(hidden.reshape(B, P, nc, chunk, d), ("batch", "seq", None, None, None))
    l_r = labels.reshape(B, P, nc, chunk)
    tot = replicate(torch.zeros((), dtype=torch.float32, device=hidden.device))
    cnt = torch.zeros_like(tot)
    for c in range(nc):
        t, n = checkpoint(
            sh.bind(_ce_chunk), h_r[:, :, c], l_r[:, :, c], head_w, vmask,
            cfg.use_kernels, use_reentrant=False, preserve_rng_state=False,
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


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def attn_cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[None, str, torch.device] = None) -> PyTree:
    """Decode cache tree, stacked over periods per pattern position, on
    ``device`` (``None``: ``cuda:0``, raising without CUDA)."""
    dev = resolve_device(device, "init_cache")
    np_ = cfg.num_periods
    caches = {}
    for i, kind in enumerate(cfg.pattern()):
        clen = attn_cache_len(cfg, max_len) if kind.mixer == "attn" else max_len
        one = init_block_cache(cfg, kind, batch, clen, torch_dtype(cfg.dtype), dev)
        leaves, treedef = tree_flatten(one)
        caches[f"pos{i}"] = tree_unflatten(
            treedef, [torch.zeros((np_,) + tuple(a.shape), dtype=a.dtype, device=dev)
                      for a in leaves]
        )
    return caches


def cache_logical(cfg: ModelConfig) -> PyTree:
    """Logical axes of every leaf of ``init_cache``'s tree."""
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    return {
        f"pos{i}": tree_map(lambda ax: ("layers",) + ax, block_cache_logical(cfg, kind),
                            is_leaf=is_axes)
        for i, kind in enumerate(cfg.pattern())
    }


def _logits(h: torch.Tensor, params, cfg) -> torch.Tensor:
    """(B, d) hidden -> (B, Vp) float32 logits of the bf16/f32 values, masked."""
    logits = head_logits(h, _head_w(params), cfg.use_kernels) + _vocab_mask(cfg, h.device)
    return constrain(logits, ("batch", "vocab"))


def prefill(params, cfg: ModelConfig, tokens=None, embeds=None):
    """Returns (last-token logits (B, Vp) float32, cache)."""
    hidden, _, caches = forward_hidden(params, cfg, tokens, embeds, collect_cache=True)
    return _logits(hidden[:, -1, :], params, cfg), caches


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos):
    """One decode step.  tokens: (B,) int; pos: a scalar (int or 0-d tensor:
    the uniform batch position) or a (B,) tensor (continuous batching:
    per-slot positions).

    Returns (logits (B, Vp) float32, cache): the cache given, updated in place.
    """
    x = _embed_in(params, cfg, tokens[:, None])
    dev = x.device
    pos_t = torch.as_tensor(pos, dtype=torch.long, device=dev)
    multi = pos_t.dim() == 1
    positions = replicate(pos_t[:, None] if multi else pos_t.reshape(1))
    pattern = cfg.pattern()
    layers = {
        f"pos{i}": _unstack(params["layers"][f"pos{i}"], cfg.num_periods)
        for i in range(len(pattern))
    }
    for period in range(cfg.num_periods):
        for i, kind in enumerate(pattern):
            c = {k: v[period] for k, v in cache[f"pos{i}"].items()}
            ring = False
            wp = pos_t
            if kind.mixer == "attn" and not multi:
                clen = c["k"].shape[1]
                ring = bool(cfg.sliding_window) and clen <= cfg.sliding_window
                wp = pos_t % clen if ring else pos_t
            x, nc, _ = block_fwd(
                layers[f"pos{i}"][period], x, kind, cfg, positions,
                cache=c, write_pos=wp, ring=ring,
            )
            for k, new in nc.items():
                if new is not c[k]:
                    if sh.is_sharded(new):
                        new = sh.redistribute(new, c[k].placements)
                    c[k].copy_(new)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rmsnorm_eps, cfg.use_kernels)
    return _logits(x[:, 0, :], params, cfg), cache
