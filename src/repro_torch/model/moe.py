"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(port of ``repro/model/moe.py``).

Dispatch groups are (batch row x sequence shard), as in the reference: each
group sorts its (tokens x k) assignments by expert and fills a capacity
buffer of ``_capacity(S / P, ...)`` slots per expert, P the model-axis
sequence shards of a ``shard_ctx`` (``_seq_shards``; 1 without one);
decode-sized workloads (``B * S <= 4096``) use one global group.  So under a
mesh whose ``model`` axis splits the sequence the MoE computes a different
function from the unsharded one: the reference's, grouped by shard.

The groups are handled together: group ``g`` writes its slot ``s`` of expert
``e`` to row ``g * C + s`` of one ``(E, G * C, d)`` buffer, so the expert
products see one contiguous operand per weight (the reference's ``(G, E, C,
d)`` einsum computes the same rows).  Assignments past the capacity are
dropped on write and read back as zeros, as ``mode="drop"`` / ``mode="fill"``
do.

Bit-for-bit choices, where the reference's semantics leave the port a
choice:

* **top-k** is a stable descending sort of the probabilities, first k taken:
  equal probabilities go to the lower expert index, as ``jax.lax.top_k``.
* **the sort by expert** is stable (``jnp.argsort`` is), so slots fill in
  token order.
* **the combine** adds each token's k weighted rows one at a time in
  ascending expert order, from zeros in the buffer's type, rounding after
  every add: the order of the reference's scatter-add on the CPU, and free of
  atomics, so a token's output does not depend on the batch around it.

The expert products are ``grouped_matmul`` (the CUDA kernel on CUDA tensors,
its plain version on CPU tensors) under ``cfg.use_kernels == "cuda"`` and the
plain batched matmul under ``"off"``; both round the gate and up products to
the activation type before ``silu(gate) * up``, as the reference does.
``grouped_matmul`` is differentiable (``kernels/moe_gmm/ops.py``: dx through
the kernel on the transposed weights, dw as one float32-accumulated
``bmm``), so both modes train.

``moe_ffn`` is ``moe_dispatch`` (router, aux losses, the dispatch into the
expert buffer) followed by ``moe_combine`` (the expert products, the combine
and the shared experts): the ``save_dispatch`` remat policy
(``model/lm.py``) checkpoints the two halves apart, so that the buffer
between them is saved (the reference's ``checkpoint_name(buf,
"moe_dispatch")``).

Under a ``shard_ctx`` the tensors are DTensors: each rank dispatches its own
groups (``sharding.local_call``; the global group on gathered tokens), the
buffer of its groups' rows is redistributed from token-sharded to
expert-sharded (the reference's constraint pair: DTensor's all-to-all),
the experts run on their shards and the output goes back the same way to
the ranks that combine it.  A buffer's rows within an expert may then lie in
another global order than the unsharded one's; every product is row by row
and each rank combines the rows it dispatched, so the result is the same.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain, current_ctx
from repro_torch.model.layers import ParamDef, dense, mlp_defs, silu, swiglu


def moe_defs(cfg) -> Dict[str, ParamDef]:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    defs = {
        "router": ParamDef((d, E), ("fsdp", None), dtype="float32"),
        "w_gate": ParamDef((E, d, f), ("experts", "fsdp", None)),
        "w_up": ParamDef((E, d, f), ("experts", "fsdp", None)),
        "w_down": ParamDef((E, f, d), ("experts", None, "fsdp")),
    }
    if cfg.num_shared_experts:
        defs["shared"] = mlp_defs(d, cfg.num_shared_experts * f)
    return defs


def _capacity(n_tokens: int, k: int, num_experts: int, factor: float) -> int:
    c = int(n_tokens * k * factor / num_experts) + 1
    c = -(-c // 8) * 8  # round up to multiple of 8
    return min(c, n_tokens * k)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_dispatch(x: torch.Tensor, probs: torch.Tensor, k: int, capacity: int):
    """G dispatch groups at once.

    x: (G, N, d); probs: (G, N, E) float32.  Returns (buf (E, G*C, d), meta):
    meta holds, per token and in ascending expert order, its k buffer rows,
    whether each was kept, and its gates, then the (G, E) counts and the
    top-k experts.
    """
    G, N, d = x.shape
    E = probs.shape[-1]
    C = capacity
    dev = x.device
    gate_vals, gate_idx = _top_k(probs, k)  # (G, N, k)
    gate_vals = gate_vals / (torch.sum(gate_vals, dim=-1, keepdim=True) + 1e-9)

    M = N * k
    e_flat = gate_idx.reshape(G, M)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    t_sorted = order // k
    g_base = torch.arange(G, device=dev)[:, None]
    # (group, expert) counts as a scatter of ones: a static shape, which
    # meta tensors and DTensor shards take (``bincount``'s depends on the data)
    counts = torch.zeros(G * E, dtype=torch.long, device=dev).scatter_add_(
        0, (e_flat + g_base * E).reshape(-1), torch.ones(G * M, dtype=torch.long, device=dev)
    ).reshape(G, E)
    offsets = torch.cumsum(counts, dim=-1) - counts
    slot = torch.arange(M, device=dev) - torch.gather(offsets, 1, e_sorted)
    kept = slot < C

    # buffer row of each kept assignment; the dropped ones go to one spare row
    GC = G * C
    rows = e_sorted * GC + g_base * C + slot
    dest = torch.where(kept, rows, E * GC).reshape(-1)
    src = torch.full((E * GC + 1,), G * N, dtype=torch.long, device=dev)
    src.index_copy_(0, dest, (t_sorted + g_base * N).reshape(-1))
    x_pad = torch.cat([x.reshape(G * N, d), x.new_zeros((1, d))])
    buf = x_pad[src[:E * GC]].reshape(E, GC, d)

    # per token: its assignments' rows in ascending expert order
    row_of = torch.empty_like(rows).scatter_(1, order, rows).reshape(G, N, k)
    kept_of = torch.empty_like(kept).scatter_(1, order, kept).reshape(G, N, k)
    asc = torch.argsort(gate_idx, dim=-1)  # k distinct experts per token
    meta = (
        torch.gather(row_of, 2, asc).reshape(G * N, k),
        torch.gather(kept_of, 2, asc).reshape(G * N, k),
        torch.gather(gate_vals, 2, asc).reshape(G * N, k),
        counts,
        gate_idx,
    )
    return buf, meta


def _group_combine(out_buf: torch.Tensor, meta) -> torch.Tensor:
    """out_buf: (E, G*C, d) -> (G*N, d): each token's weighted rows added in
    ascending expert order from zeros, one rounding per add."""
    rows, kept, gates = meta[:3]
    d = out_buf.shape[-1]
    flat = out_buf.reshape(-1, d)
    last = flat.shape[0] - 1
    y = torch.zeros((rows.shape[0], d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(rows.shape[1]):
        v = flat[rows[:, j].clamp(max=last)] * gates[:, j, None].to(out_buf.dtype)
        y = y + v.masked_fill(~kept[:, j, None], 0)
    return y


def _gmm(x: torch.Tensor, w: torch.Tensor, kernels: str) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f) in x.dtype, float32 accumulation."""
    if kernels == "cuda":
        from repro_torch.kernels.moe_gmm.ops import grouped_matmul

        return grouped_matmul(x, w)
    if kernels != "off":
        raise ValueError(f"use_kernels={kernels!r}, not 'off' or 'cuda'")
    return torch.matmul(x, w)


def _expert_ffn(params, buf: torch.Tensor, kernels: str) -> torch.Tensor:
    """Grouped SwiGLU: buf (E, C, d) -> (E, C, d); the gate and up products
    are rounded to buf.dtype before ``silu(gate) * up``."""
    h = silu(_gmm(buf, params["w_gate"], kernels)) * _gmm(buf, params["w_up"], kernels)
    return _gmm(h, params["w_down"], kernels)


def _aux_losses(probs: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss per group: probs (G, N, E), counts (G, E) ->
    (G,)."""
    E = probs.shape[-1]
    importance = torch.mean(probs, dim=1)
    total = torch.sum(counts, dim=-1, keepdim=True)
    load = counts.float() / total.clamp_min(1)
    return E * torch.sum(importance * load, dim=-1)


def _seq_shards(seq: int) -> int:
    ctx = current_ctx()
    if ctx is None or ctx.rules.get("seq") != "model":
        return 1
    m = sh.ctx_axis_size("model")
    return m if (m > 1 and seq % m == 0) else 1


def _dispatch_local(x, probs, k: int, cap: int, groups_per_row: bool):
    """Dispatch the tokens of x (B, S, d): one group per row, or one group
    of all.  Returns (buf, rows, kept, gates, per-group balance)."""
    B, S, d = x.shape
    E = probs.shape[-1]
    G, N = (B, S) if groups_per_row else (1, B * S)
    p_g = probs.reshape(G, N, E)
    buf, meta = _group_dispatch(x.reshape(G, N, d), p_g, k, cap)
    return (buf, *meta[:3], _aux_losses(p_g, meta[3]))


def _token_placements(shape, per_row: bool, mesh):
    """Placements of the tokens a rank dispatches: its rows and, with
    sequence shards, its shard (the constrained x's), or all tokens for
    the global group."""
    if not per_row:
        return (sh.Replicate(),) * mesh.ndim
    dims = (0, 1) if _seq_shards(shape[1]) > 1 else (0,)
    return sh.keep(sh.ctx_placements(("batch", "seq", "embed"), shape), dims)


def moe_dispatch(params, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (buf (E, G*C, d), route, aux): ``route`` holds each
    token's k buffer rows, whether each was kept, and its gates, as
    ``_group_combine`` reads them."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token

    x = constrain(x, ("batch", "seq", "embed"))
    logits = dense(x, params["router"].to(x.dtype)).float()  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # one global group for decode-sized workloads, else one group per
    # (row, sequence shard)
    per_row = B * S > 4096
    cap = _capacity(S // _seq_shards(S) if per_row else B * S, k, E, cfg.capacity_factor)
    if not sh.is_sharded(x):
        buf, rows, kept, gates, bal = _dispatch_local(x, probs, k, cap, per_row)
    else:
        px = _token_placements(x.shape, per_row, x.device_mesh)
        ptok = sh.mapped(px, {0: 0, 1: 0})
        buf, rows, kept, gates, bal = sh.local_call(
            lambda x, p: _dispatch_local(x, p, k, cap, per_row), (x, probs), (px, px),
            (sh.mapped(px, {0: 1, 1: 1}), ptok, ptok, ptok, ptok),
        )
        # tokens -> experts all-to-all (sequence-sharded -> expert-sharded)
        buf = constrain(buf, ("experts", "batch", None) if per_row else ("experts", None, None))
    aux = {"moe_balance": torch.mean(bal).float(), "moe_zloss": z_loss.float()}
    return buf, (rows, kept, gates), aux


def moe_combine(params, x: torch.Tensor, buf: torch.Tensor, route, cfg) -> torch.Tensor:
    """The expert products on ``buf``, each token's rows combined, plus the
    shared experts on ``x`` (B, S, d) -> (B, S, d)."""
    out = _expert_ffn(params, buf, cfg.use_kernels)
    if not sh.is_sharded(out):
        y = _group_combine(out, route).reshape(x.shape)
    else:
        px = _token_placements(x.shape, x.shape[0] * x.shape[1] > 4096, out.device_mesh)
        ptok = sh.mapped(px, {0: 0, 1: 0})
        pbuf = sh.mapped(px, {0: 1, 1: 1})
        local_shape = sh.local_shape(x.shape, px, out.device_mesh)
        # experts -> tokens all-to-all back, to the ranks that dispatched
        out = constrain(out, ("experts", None, None))
        y = sh.local_call(
            lambda o, r, kp, g: _group_combine(o, (r, kp, g)).reshape(local_shape),
            (out, *route), (pbuf, ptok, ptok, ptok), px,
        )
    if cfg.num_shared_experts:
        sh_p = params["shared"]
        y = y + swiglu(x, sh_p["w_gate"], sh_p["w_up"], sh_p["w_down"])
    return constrain(y, ("batch", "seq", "embed"))


def moe_ffn(params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux)."""
    buf, route, aux = moe_dispatch(params, x, cfg)
    return moe_combine(params, x, buf, route, cfg), aux
