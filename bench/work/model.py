"""Model FLOPs of a call: the matrix products the model needs, from the
configuration's sizes alone.

A forward counts the projections (2 operations a weight a token), the
sequence mixer's products (causal attention over its (query, key) pairs,
or the SSD scan's, ``kernels.ssd_scan``) and the LM head over the true
vocabulary (not its padding) at every position that needs logits.  A
training step is three forwards' worth (the backward is two), and counts
no recompute.  Elementwise work (norms, activations, the causal conv,
softmax, the optimizer) is not counted.  A family's block is counted by
``bench/work/<family>.py``, found by the configuration's ``family``.
"""

from __future__ import annotations

import importlib


def family(model: dict):
    """The module ``bench.work.<family>`` of the model's family."""
    return importlib.import_module(f"bench.work.{model['family']}")


def block_weights(model: dict) -> int:
    return family(model).block_weights(model)


def mixer_flops(model: dict, B: int, S: int) -> float:
    return family(model).mixer_flops(model, B, S)


def forward_flops(model: dict, B: int, S: int, head_positions: int) -> float:
    """One forward over B sequences of S tokens, with the head at
    ``head_positions`` positions in all."""
    L = model["num_layers"]
    tokens = B * S
    return (L * (2 * tokens * block_weights(model) + mixer_flops(model, B, S))
            + 2 * head_positions * model["d_model"] * model["vocab_size"])


def train_flops(model: dict, B: int, S: int) -> float:
    """One training step: loss over every position, forward and backward."""
    return 3 * forward_flops(model, B, S, B * S)


def prefill_flops(model: dict, B: int, S: int) -> float:
    """One prefill: every position through the blocks, the head at the last."""
    return forward_flops(model, B, S, B)


def rmsnorm_launches(model: dict, rows: int, train: bool) -> list:
    """(R, d, dtype) of every RMSNorm launch of one call: a forward applies
    each block's norms (``norm_widths``) and the final norm; a training
    step under block remat runs every block's norms once more in its
    recompute."""
    block = [(rows, w, model["dtype"]) for w in family(model).norm_widths(model)]
    L = model["num_layers"]
    forward = block * L + [(rows, model["d_model"], model["dtype"])]
    if train and model.get("remat", "block") == "block":
        return forward + block * L
    return forward
