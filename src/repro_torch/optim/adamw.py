"""AdamW with cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``), as plain functions on trees of tensors.

The update is the reference's, operation for operation, in float32: clip by
the global norm, ``u = (m / bc1) / (sqrt(v / bc2) + eps)``, ``p -= lr * (u +
wd * p)``, stored back in the parameter's dtype.  (``torch.optim.AdamW`` orders
its operations otherwise.)  Moments are float32; ``keep_master=True`` adds a
float32 master copy.  The update is functional: it returns new tensors and
leaves its inputs as they were; it runs over each leaf in slices, so that its
float32 temporaries stay small beside the moments.

Sharded (DTensor) parameters keep their moments as DTensors of the same
placements.  The update is elementwise, so it runs on each rank's local
shards (a gradient is first brought to its parameter's placements); the
global gradient norm is one all-reduce of the ranks' local sums of squares,
each leaf's divided by the number of ranks that hold a copy of its shard.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any
SLICE = 1 << 26  # elements of a leaf updated at once (float32 temporaries of 256 MB)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    keep_master: bool = False


def lr_at(opt: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - opt.warmup_steps) / max(opt.total_steps - opt.warmup_steps, 1), 0, 1
    )
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return opt.lr * warm * (opt.min_lr_frac + (1 - opt.min_lr_frac) * cos)


def init_opt_state(params: PyTree, opt: OptConfig) -> Dict[str, Any]:
    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    state = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if opt.keep_master:
        state["master"] = tree_map(lambda p: p.detach().float(), params)
    return state


def global_norm(tree: PyTree) -> torch.Tensor:
    """The gradients' global norm.  DTensor leaves add their local shards'
    sums of squares, each divided by its copies, and one all-reduce over
    the mesh's ranks gives the total; plain leaves are summed as they are."""
    leaves = tree_leaves(tree)
    mesh = next((g.device_mesh for g in leaves if isinstance(g, DTensor)), None)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))

    def local_sq(g):
        if not isinstance(g, DTensor):
            raise TypeError("global_norm: plain and sharded gradients mixed")
        g = _reduced(g)
        copies = math.prod(mesh.size(i) for i, p in enumerate(g.placements)
                           if isinstance(p, Replicate))
        return torch.sum(torch.square(g.to_local().float())) / copies

    total = sum(local_sq(g) for g in leaves)
    if mesh.size() == dist.get_world_size():
        dist.all_reduce(total)
    else:
        for i in range(mesh.ndim):
            dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


def _reduced(g: DTensor) -> DTensor:
    """``g`` with its partial sums reduced (its shards kept)."""
    if not any(p.is_partial() for p in g.placements):
        return g
    return g.redistribute(g.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in g.placements])


@torch.no_grad()
def adamw_update(
    params: PyTree, grads: PyTree, state: Dict[str, Any], opt: OptConfig
) -> Tuple[PyTree, Dict[str, Any], Dict[str, torch.Tensor]]:
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(opt.clip_norm / (gn + 1e-9), max=1.0)
    lr = lr_at(opt, step)
    t = step.float()
    bc1 = 1 - torch.pow(torch.tensor(opt.b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(opt.b2, device=t.device), t)

    def upd(src, p, g, m, v):
        """One leaf, in slices of ``SLICE`` elements (each element's
        operations are the same, so the result is the whole leaf's bit for
        bit) written into new tensors: the float32 temporaries of a stacked
        expert weight would otherwise be gigabytes each.  A DTensor leaf is
        updated shard by shard."""
        if isinstance(p, DTensor):
            g = g.redistribute(p.device_mesh, p.placements)
            outs = upd(*(t.to_local() for t in (src, p, g, m, v)))
            wrap = lambda t: None if t is None else DTensor.from_local(  # noqa: E731
                t, p.device_mesh, p.placements, run_check=False)
            return (wrap(outs[0]).requires_grad_(p.requires_grad), *map(wrap, outs[1:]))
        new_p = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        new_m, new_v = torch.empty_like(m), torch.empty_like(v)
        master = torch.empty_like(m) if opt.keep_master else None
        ins = [t.reshape(-1) for t in (src, g, m, v)]
        outs = [t.reshape(-1) for t in (new_p, new_m, new_v, master) if t is not None]
        for i in range(0, p.numel(), SLICE):
            ps, gs, ms, vs = (t[i:i + SLICE] for t in ins)
            gs = gs.float() * scale
            ms = opt.b1 * ms + (1 - opt.b1) * gs
            vs = opt.b2 * vs + (1 - opt.b2) * torch.square(gs)
            u = (ms / bc1) / (torch.sqrt(vs / bc2) + opt.eps)
            pf = ps.float()
            pf = pf - lr * (u + opt.weight_decay * pf)
            for out, val in zip(outs, (pf, ms, vs, pf)):
                out[i:i + SLICE].copy_(val)  # the parameter rounds to its dtype here
        return new_p.requires_grad_(p.requires_grad), master, new_m, new_v

    flat_p, treedef = tree_flatten(params)
    flat_src = tree_leaves(state.get("master", params))
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state["m"])
    flat_v = tree_leaves(state["v"])
    out = [upd(*leaves) for leaves in zip(flat_src, flat_p, flat_g, flat_m, flat_v)]
    new_params = tree_unflatten(treedef, [o[0] for o in out])
    new_state = {
        "m": tree_unflatten(treedef, [o[2] for o in out]),
        "v": tree_unflatten(treedef, [o[3] for o in out]),
        "step": step,
    }
    if opt.keep_master:
        new_state["master"] = tree_unflatten(treedef, [o[1] for o in out])
    metrics = {"grad_norm": gn, "lr": lr}
    return new_params, new_state, metrics
