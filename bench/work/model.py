"""Model FLOPs of a call: the matrix products the model needs, from the
configuration's sizes alone.

A forward counts the projections (2 operations a weight a token), the
sequence mixer's products (causal attention over its (query, key) pairs,
or the SSD scan's, ``kernels.ssd_scan``) and the LM head over the true
vocabulary (not its padding) at every position that needs logits, tied or
not.  Layers are counted by kind: the leading dense layers
(``first_k_dense``) by ``bench/work/dense.py``, the rest by
``bench/work/<family>.py``, found by the configuration's ``family``.  A
training step is three forwards' worth (the backward is two), and counts
no recompute.  Elementwise work (norms, activations, the causal conv,
softmax, the optimizer) is not counted; the RMSNorm launches are listed
apart (:func:`rmsnorm_launches`), recompute included.
"""

from __future__ import annotations

import importlib

from bench.reference.lm import family_layers, lead_layers

RERUN_BLOCKS = ("block", "save_dispatch")  # remat policies that rerun every block's norms


def family(model: dict):
    """The module ``bench.work.<family>`` of the model's family."""
    return importlib.import_module(f"bench.work.{model['family']}")


def mixer_flops(model: dict, B: int, S: int) -> float:
    return family(model).mixer_flops(model, B, S)


def kinds(model: dict) -> list:
    """(layers, module) of each kind of layer: the leading dense layers,
    then the family's."""
    return [(lead_layers(model), family({"family": "dense"})),
            (family_layers(model), family(model))]


def forward_flops(model: dict, B: int, S: int, head_positions: int) -> float:
    """One forward over B sequences of S tokens, with the head at
    ``head_positions`` positions in all."""
    tokens = B * S
    blocks = sum(n * (2 * tokens * kind.block_weights(model) + kind.mixer_flops(model, B, S))
                 for n, kind in kinds(model) if n)
    return blocks + 2 * head_positions * model["d_model"] * model["vocab_size"]


def train_flops(model: dict, B: int, S: int) -> float:
    """One training step: loss over every position, forward and backward."""
    return 3 * forward_flops(model, B, S, B * S)


def prefill_flops(model: dict, B: int, S: int) -> float:
    """One prefill: every position through the blocks, the head at the last."""
    return forward_flops(model, B, S, B)


def rmsnorm_launches(model: dict, rows: int, train: bool) -> list:
    """(R, d, dtype) of every RMSNorm launch of one call: a forward applies
    each block's norms (``norm_widths`` of its kind: the leading dense
    layers', then the family's) and the final norm; a training step under a
    remat policy that reruns the blocks (``block``, and ``save_dispatch``,
    whose MoE blocks rerun the mixer and the FFN's norm and whose other
    blocks rerun whole) runs every block's norms once more in its
    recompute, and under ``none`` not at all."""
    blocks = [(rows, w, model["dtype"])
              for n, kind in kinds(model) for w in kind.norm_widths(model) * n]
    forward = blocks + [(rows, model["d_model"], model["dtype"])]
    if train and model.get("remat", "block") in RERUN_BLOCKS:
        return forward + blocks
    return forward
