"""Work of one block of the ``ssm`` family (the Mamba-2 mixer), from the
configuration's sizes alone."""

from __future__ import annotations

from bench.work.kernels import ssd_scan


def block_weights(model: dict) -> int:
    """Weights of one block that multiply every token: the x, z, B, C and dt
    projections in, the out projection."""
    d = model["d_model"]
    di, ds = model["ssm_expand"] * d, model["ssm_state"]
    nh = di // model["ssm_head_dim"]
    return d * (2 * di + 2 * ds + nh) + di * d


def mixer_flops(model: dict, B: int, S: int) -> float:
    """The SSD scan's products over B sequences of S, one layer."""
    di = model["ssm_expand"] * model["d_model"]
    P = model["ssm_head_dim"]
    return ssd_scan(B, S, di // P, P, model["ssm_state"], model["ssm_chunk"], model["dtype"])[0]


def norm_widths(model: dict) -> list:
    """Widths of a block's RMSNorm launches: the mixer's norm and the gated
    norm of its output."""
    return [model["d_model"], model["ssm_expand"] * model["d_model"]]
