"""AdamW as the configurations state it, in float32: a warm-up then cosine
learning rate, the gradients clipped by their global norm, bias-corrected
moments, decoupled weight decay on every leaf, each new parameter stored in
its leaf's type."""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * frac))
    return opt["lr"] * warm * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * cos)


def clipped(grads: Dict[str, torch.Tensor], clip_norm: float) -> Dict[str, torch.Tensor]:
    """The gradients as the update takes them: scaled down to a global norm
    of at most ``clip_norm``."""
    gn = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
    scale = min(clip_norm / (float(gn) + 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}


@torch.no_grad()
def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           state: Dict[str, Dict[str, torch.Tensor]], step: int, opt: dict) -> None:
    """One step in place: ``params`` (their own types), ``state['m'|'v']``
    float32, ``step`` counted from 1."""
    g = clipped(grads, opt["clip_norm"])
    lr = lr_at(opt, step)
    bc1, bc2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
    for k, p in params.items():
        m = state["m"].setdefault(k, torch.zeros_like(p, dtype=torch.float32))
        v = state["v"].setdefault(k, torch.zeros_like(p, dtype=torch.float32))
        m.mul_(opt["b1"]).add_((1 - opt["b1"]) * g[k])
        v.mul_(opt["b2"]).add_((1 - opt["b2"]) * g[k] * g[k])
        u = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        pf = p.float()
        p.copy_(pf - lr * (u + opt["weight_decay"] * pf))
