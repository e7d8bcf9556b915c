"""Work of one block of the ``dense`` family (grouped-query causal attention
and a SwiGLU MLP), from the configuration's sizes alone."""

from __future__ import annotations


def block_weights(model: dict) -> int:
    """Weights of one block that multiply every token."""
    d = model["d_model"]
    H, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    return d * H * hd + 2 * d * kv * hd + H * hd * d + 3 * d * model["d_ff"]


def mixer_flops(model: dict, B: int, S: int) -> float:
    """Causal attention over the (query, key) pairs of B sequences of S
    (QK^T and PV), one layer."""
    pairs = B * S * (S + 1) // 2
    return 4 * pairs * model["num_heads"] * model["head_dim"]


def norm_widths(model: dict) -> list:
    """Widths of a block's RMSNorm launches: before the mixer and the MLP."""
    return [model["d_model"], model["d_model"]]
