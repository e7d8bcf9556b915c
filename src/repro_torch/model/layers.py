"""Shared layer primitives and the parameter-definition machinery (port of
``repro/model/layers.py``).

Parameters are plain nested dicts of tensors.  Every leaf is described by a
:class:`ParamDef` carrying its shape, its logical axis names and an init rule;
``distributed/sharding.py`` maps the logical axes onto a mesh (the model code
never names a mesh axis), and the constraints of ``swiglu`` are the
reference's (identities without a ``shard_ctx``).

Init draws from an explicit ``torch.Generator`` with the reference's rules
(fan-in scaled normal at the def's scale, zeros, ones, the SSM rules), on
the CPU or in place on the card (whose numbers differ from the CPU's for one
seed).  The two frameworks give different numbers from one seed, so tests
carry the reference's weights across with ``model/convert.py``.

``rms_norm`` takes the kernel mode (``cfg.use_kernels``, passed by every
caller): ``"off"`` is the reference's plain function, ``"cuda"`` the RMSNorm
kernel (``kernels/rmsnorm``; its plain version on CPU tensors).

``device=None`` means ``cuda:0`` wherever the port places tensors
(:func:`resolve_device`), and raises when CUDA is not available; the tests
pass ``device="cpu"``.

``REPRO_BF16_DOTS=1`` is the reference's experiment switch
(:func:`bf16_dots`, read at each call): its dots then emit the operands' type
instead of float32.  It rounds the decode's QK scores (``model/attention.
py``); in :func:`dense` it changes nothing, since the port's product
already comes out in ``x.dtype`` from a float32 accumulation, rounded once,
which is the reference's value under either setting.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.paramdef import ParamDef, is_paramdef
from repro_torch.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def resolve_device(device: Union[None, str, torch.device], who: str = "repro_torch"
                   ) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without CUDA); else the device named."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: device {dev} asked for, but CUDA is not available "
                f"(pass device='cpu' to run on the CPU)"
            )
        if dev.index is None:  # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stack_defs(defs: PyTree, n: int) -> PyTree:
    """Add a leading ('layers',) stacking axis of size ``n`` to every ParamDef."""

    def f(d: ParamDef) -> ParamDef:
        return dataclasses.replace(
            d, shape=(n,) + d.shape, logical=("layers",) + d.logical
        )

    return tree_map(f, defs, is_leaf=is_paramdef)


def init_leaf(d: ParamDef, gen: torch.Generator, default_dtype,
              device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """One leaf by its def's rule, drawn from ``gen`` on ``device`` (the
    generator's device).  On a card the fan-in scaled normal is drawn in
    place in the leaf's type, with no float32 copy; the CPU draws it in
    float32 and casts."""
    dtype = torch_dtype(d.dtype or default_dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "ssm_a":  # A_log: log of uniform [1, 16]
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32, device=device) * 15.0 + 1.0
        return torch.log(u).to(dtype)
    if d.init == "ssm_dt":  # dt bias: inverse-softplus of uniform [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32, device=device) * (hi - lo) + lo
        dt = torch.exp(u)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    # fan-in scaled normal
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale else 1.0 / math.sqrt(fan_in)
    if device.type != "cpu":
        return torch.empty(d.shape, dtype=dtype, device=device).normal_(0.0, scale, generator=gen)
    return (torch.randn(d.shape, generator=gen, dtype=torch.float32) * scale).to(dtype)


def abstract_params(defs: PyTree, default_dtype="bfloat16") -> PyTree:
    """Meta-device tensors of the defs' shapes and dtypes (no storage)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype or default_dtype),
                                          device="meta"), defs, is_leaf=is_paramdef)


def logical_axes(defs: PyTree) -> PyTree:
    """Tree of logical-axis tuples with the same structure as the params."""
    return tree_map(lambda d: d.logical, defs, is_leaf=is_paramdef)


def param_count(defs: PyTree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs, is_leaf=is_paramdef))


def init_params(defs: PyTree, seed: int = 0, default_dtype="bfloat16",
                device: Union[None, str, torch.device] = None) -> PyTree:
    """Draw every leaf on ``device`` (``None``: ``cuda:0``) from one generator
    of that device seeded with ``seed``, in leaf order; leaves require grad.

    A card draws in place (a full-width MoE model's expert leaves are 10 GB
    each in bfloat16), so a card's weights differ from the CPU's for the same
    seed, and the CPU's are the ones the tests see."""
    device = resolve_device(device, "init_params")
    leaves, treedef = tree_flatten(defs, is_leaf=is_paramdef)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = [init_leaf(d, gen, default_dtype, device).requires_grad_(True) for d in leaves]
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             kernels: str) -> torch.Tensor:
    """RMSNorm over the last axis.  ``kernels`` is the caller's
    ``cfg.use_kernels``: ``"cuda"`` runs the RMSNorm kernel (differentiable),
    ``"off"`` this plain function.  It has no default, so that no caller
    takes the plain path on the card by leaving it out."""
    if kernels == "cuda":
        from repro_torch.kernels.rmsnorm.ops import rmsnorm

        return rmsnorm(x, scale, eps)
    if kernels != "off":
        raise ValueError(f"kernels={kernels!r}, not 'off' or 'cuda'")
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables computed on the fly.  positions: any shape of ints."""
    from repro_torch.distributed.sharding import replicate

    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = replicate(1.0 / (theta ** exps))
    ang = positions.float()[..., None] * inv_freq  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def bf16_dots() -> bool:
    """The reference's ``REPRO_BF16_DOTS=1`` switch, read at call time."""
    return os.environ.get("REPRO_BF16_DOTS") == "1"


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul over the last axis of ``x``, result in ``x.dtype``, accumulated
    in float32: a float32 product for float32 operands; for bfloat16 ones
    the card's matrix product accumulates in float32 and rounds once to the
    result type, which is the reference's f32 dot followed by the cast.
    Under ``REPRO_BF16_DOTS=1`` the reference's dot emits ``x.dtype`` (mixed
    types promote to float32 first): the same values, so the switch takes no
    branch here.  On DTensors it runs on each rank's shards
    (``sharding.contract``)."""
    from repro_torch.distributed import sharding as sh

    if sh.is_sharded(x, w):
        return sh.contract(dense, x, w)
    if x.dtype != w.dtype:
        return torch.matmul(x.float(), w.float()).to(x.dtype)
    return torch.matmul(x, w)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    from repro_torch.distributed.sharding import constrain, current_ctx

    h = silu(dense(x, w_gate)) * dense(x, w_up)
    ctx = current_ctx()
    if ctx is not None and ctx.rules.get("ffn_act_seq"):
        # seq-sharded down-projection: a2a the activation, gather the weight
        h = constrain(h, ("batch", "ffn_act_seq", None))
    else:
        h = constrain(h, ("batch", "seq_full", "ff"))  # Megatron row-parallel
    return dense(h, w_down)


def mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("fsdp", "tp")),
        "w_up": ParamDef((d_model, d_ff), ("fsdp", "tp")),
        "w_down": ParamDef((d_ff, d_model), ("tp", "fsdp")),
    }


def norm_defs(d_model: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((d_model,), (None,), init="ones", dtype="float32")}
