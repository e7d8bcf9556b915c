"""Plain float32 reference of the benchmark's language models, written from
their published descriptions in plain PyTorch; it imports nothing of the
program.

This module is the frame every family shares: the token embedding, a stack
of blocks each after an RMSNorm of the residual, a final RMSNorm and the
head, the training loss and the prefill.  The head is the embedding's
transpose where ``tie_embeddings`` is true, else a leaf ``head/w`` of its
own (d, padded vocabulary).  The first ``first_k_dense`` layers (absent: 0)
are the ``dense`` family's block, whatever the configuration's family:
GQA attention with RoPE and a SwiGLU of width ``d_ff``, their leaves under
``layers/lead/`` stacked over those k; ``num_layers`` counts every layer.
The family's blocks follow, their leaves under ``layers/pos0/`` stacked over
the rest (:func:`family_layers`).  A family's block is
``bench/reference/<family>.py``, found by the configuration's ``family``:
its ``param_spec(model)`` lists the block's leaves and its
``block(p, i, x, h, model, prec)`` returns the new residual, the layer's
cache and the layer's loss readings, a dict that is empty where the family
adds nothing to the loss (the leading layers read nothing).  A family
whose blocks read something defines ``loss_terms(terms, model, batch)``:
the readings of every layer of the family's stack
(``{name: [one per layer]}``) of a block of rows, turned into that block's
share of the family's own loss terms for a batch of shape ``batch`` (B, S).
The shares of the blocks of rows of a batch add up to the batch's terms, as
their cross-entropies add up to its mean (:func:`train_loss`).

Departures from the published models, which the configuration files list:
the residual stream in the activation type, and a vocabulary padded to a
multiple of 256 whose padding is masked out of the logits.

Parameters are a flat dict ``path -> tensor`` in the layout of
:func:`param_spec` (each block leaf stacked over the layers of its
group).  Every product goes through ``prec.matmul`` of the given
:class:`~bench.reference.precision.Precision`: float32 (TF32 off) for the
reference, lower for the control.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench.reference.precision import Precision

NEG_INF = -1e30
LEAD = "layers/lead/"
STACK = "layers/pos0/"


def family(model: dict):
    """The module ``bench.reference.<family>`` of the model's family."""
    return importlib.import_module(f"bench.reference.{model['family']}")


def lead_layers(model: dict) -> int:
    """The leading dense layers, ``layers/lead/``: ``first_k_dense``."""
    return model.get("first_k_dense", 0)


def family_layers(model: dict) -> int:
    """The layers of the family's stack, ``layers/pos0/``: every layer after
    the leading dense ones."""
    return model["num_layers"] - lead_layers(model)


def padded_vocab(model: dict) -> int:
    return -(-model["vocab_size"] // 256) * 256


def param_spec(model: dict) -> List[Tuple[str, tuple, str, str, Optional[float]]]:
    """(path, shape, dtype, init, scale) of every parameter.  ``init`` is
    ``normal`` (scale ``1/sqrt(fan_in)`` unless given), ``ones``, ``ssm_a``
    (log of uniform [1, 16]) or ``ssm_dt`` (inverse softplus of a step size
    log-uniform in [1e-3, 1e-1]).  The leading dense layers' leaves follow
    the embedding, the untied head comes last."""
    d, pd, k = model["d_model"], model["param_dtype"], lead_layers(model)
    spec = [("embed/tok", (padded_vocab(model), d), pd, "normal", None)]
    if k:
        spec += ([(LEAD + "norm_mixer/scale", (k, d), "float32", "ones", None)]
                 + family({"family": "dense"}).param_spec(model, LEAD, k))
    spec += ([(STACK + "norm_mixer/scale", (family_layers(model), d), "float32", "ones", None)]
             + family(model).param_spec(model)
             + [("final_norm/scale", (d,), "float32", "ones", None)])
    if not model["tie_embeddings"]:
        spec.append(("head/w", (d, padded_vocab(model)), pd, "normal", None))
    return spec


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def forward(p: Dict[str, torch.Tensor], model: dict, tokens: torch.Tensor, prec: Precision,
            want_cache: bool = False):
    """Hidden states after the final norm (b, S, d), with ``want_cache`` the
    per-layer caches {leaf: [layer tensors]}, and the blocks' loss readings
    {name: [layer tensors]} of the family's layers."""
    eps = model["rmsnorm_eps"]
    x = p["embed/tok"][tokens.long()]
    lead = family({"family": "dense"}).block
    for i in range(lead_layers(model)):
        h = rms_norm(x, p[LEAD + "norm_mixer/scale"][i], eps)
        x, _, _ = lead(p, i, x, h, model, prec, LEAD)
    block = family(model).block
    caches: Dict[str, list] = {}
    terms: Dict[str, list] = {}
    for i in range(family_layers(model)):
        h = rms_norm(x, p[STACK + "norm_mixer/scale"][i], eps)
        x, cache, read = block(p, i, x, h, model, prec)
        if want_cache:
            for key, t in cache.items():
                caches.setdefault(key, []).append(t)
        for key, t in read.items():
            terms.setdefault(key, []).append(t)
    return rms_norm(x, p["final_norm/scale"], eps), caches, terms


def logits(p: Dict[str, torch.Tensor], model: dict, h: torch.Tensor, prec: Precision):
    """(..., d) hidden -> (..., Vp) logits through the head (the embedding's
    transpose where tied, else ``head/w``), padded entries masked."""
    head = p["embed/tok"].t() if model["tie_embeddings"] else p["head/w"]
    out = prec.matmul(h, head)
    Vp = out.shape[-1]
    mask = torch.arange(Vp, device=out.device) >= model["vocab_size"]
    return out.masked_fill(mask, NEG_INF)


def train_loss(p: Dict[str, torch.Tensor], model: dict, tokens: torch.Tensor,
               labels: torch.Tensor, prec: Precision, batch: Tuple[int, int]) -> torch.Tensor:
    """A block of rows' share of the training loss of a batch of shape
    ``batch`` (B, S): the sum of its token cross-entropies over B * S, plus
    the family's ``loss_terms`` of its readings, where its blocks read any."""
    h, _, terms = forward(p, model, tokens, prec)
    lg = logits(p, model, h, prec)
    loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1).long(),
                           reduction="sum") / (batch[0] * batch[1])
    if terms:
        loss = loss + family(model).loss_terms(terms, model, batch)
    return loss


def prefill(p: Dict[str, torch.Tensor], model: dict, tokens: torch.Tensor, prec: Precision):
    """(last-token logits (b, Vp), caches {leaf: (layers, b, ...)}); no
    prefill cell has leading dense layers, whose caches it does not keep."""
    if lead_layers(model):
        raise ValueError(f"the reference's prefill takes no leading dense layers "
                         f"(first_k_dense={lead_layers(model)})")
    h, caches, _ = forward(p, model, tokens, prec, want_cache=True)
    return logits(p, model, h[:, -1], prec), {k: torch.stack(v) for k, v in caches.items()}
