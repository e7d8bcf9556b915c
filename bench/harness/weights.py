"""The weights, made by the benchmark from the seed on the device, in the
types they are served in, and handed the same to the program and to the
reference.

Every normal leaf of one type is drawn by one ``normal_`` call over a flat
buffer from a ``torch.Generator`` of the device, then scaled in place; the
uniform leaves likewise from one ``rand`` call.  The same seed on the same
device gives the same weights, so the reference makes them again after the
window instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench.reference.lm import LEAD, family_layers, lead_layers, param_spec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def make_weights(model: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Flat ``path -> tensor`` of every parameter of ``model``."""
    spec = param_spec(model)
    g = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[tuple, list] = {}
    for path, shape, dtype, init, scale in spec:
        if init == "ones":
            out[path] = torch.ones(shape, dtype=DTYPES[dtype], device=device)
        else:
            kind = "normal" if init == "normal" else "uniform"
            groups.setdefault((kind, dtype), []).append((path, shape, init, scale))
    for (kind, dtype), leaves in sorted(groups.items()):
        total = sum(math.prod(shape) for _, shape, _, _ in leaves)
        draw_type = DTYPES[dtype] if kind == "normal" else torch.float32
        buf = torch.empty(total, dtype=draw_type, device=device)
        if kind == "normal":
            buf.normal_(0.0, 1.0, generator=g)
        else:
            buf.uniform_(0.0, 1.0, generator=g)
        at = 0
        for path, shape, init, scale in leaves:
            n = math.prod(shape)
            t = buf[at:at + n].view(shape)
            at += n
            if init == "normal":
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                out[path] = t.mul_(scale if scale else 1.0 / math.sqrt(fan_in))
            elif init == "ssm_a":  # A_log: log of uniform [1, 16]
                out[path] = torch.log(t * 15.0 + 1.0).to(DTYPES[dtype])
            elif init == "ssm_dt":  # inverse softplus of exp(uniform [log 1e-3, log 1e-1])
                lo, hi = math.log(1e-3), math.log(1e-1)
                dt = torch.exp(t * (hi - lo) + lo)
                out[path] = (dt + torch.log(-torch.expm1(-dt))).to(DTYPES[dtype])
            else:
                raise ValueError(f"{path}: unknown init {init!r}")
    return {path: out[path] for path, *_ in spec}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`nest`, in the tree's order."""
    out: Dict[str, torch.Tensor] = {}
    for key, node in tree.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            out.update(flatten(node, path + "/"))
        else:
            out[path] = node
    return out


def leaf_tensors(flat: Dict[str, torch.Tensor], model: dict) -> Dict[str, torch.Tensor]:
    """One entry per layer of each stacked block leaf, ``path[i]`` (a
    ``layers/...`` leaf carries its group's layers on its first axis: the
    leading dense layers under ``layers/lead/``, the family's stack
    otherwise), the other leaves as they are: the leaves the training check
    compares one by one."""
    out: Dict[str, torch.Tensor] = {}
    for path, t in flat.items():
        if path.startswith("layers/"):
            n = lead_layers(model) if path.startswith(LEAD) else family_layers(model)
            if t.shape[0] != n:
                raise ValueError(f"{path}: {t.shape[0]} layers stacked, not {n}")
            for i in range(n):
                out[f"{path}[{i}]"] = t[i]
        else:
            out[path] = t
    return out
