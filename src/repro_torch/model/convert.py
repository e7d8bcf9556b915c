"""Carry parameters between the JAX package and the port.

The two packages share one parameter tree — nested dicts, every block leaf
stacked per period position — so the carry-over is leaf by leaf: numpy
arrays in, tensors of the def's dtype out, and back.  bfloat16 leaves leave
the port as float32 arrays (a lossless widening); the JAX side's own
bfloat16 arrays should be widened to float32 before they are handed in.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.model.layers import resolve_device, torch_dtype
from repro_torch.model.lm import model_defs
from repro_torch.paramdef import is_paramdef
from repro_torch.pytree import tree_map

PyTree = Any


def params_from_numpy(tree: PyTree, cfg, device: Union[None, str, torch.device] = None
                      ) -> PyTree:
    """The port's parameters (leaves that require grad) from a tree of numpy
    arrays shaped as ``lm.model_defs(cfg)``, on ``device`` (``None``:
    ``cuda:0``, raising without CUDA)."""
    device = resolve_device(device, "params_from_numpy")

    def leaf(d, a):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"parameter shape {a.shape} != def shape {d.shape}")
        if a.dtype.kind not in "fiub":  # bfloat16 and other non-numpy types
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a, copy=True))
        dtype = torch_dtype(d.dtype or cfg.param_dtype)
        return t.to(device=device, dtype=dtype).requires_grad_(True)

    return tree_map(leaf, model_defs(cfg), tree, is_leaf=is_paramdef)


def params_to_numpy(params: PyTree) -> PyTree:
    """numpy arrays of the port's parameters; bfloat16 widens to float32."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, params)
