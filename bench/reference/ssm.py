"""The ``ssm`` family of the plain reference (Mamba-2, arXiv:2405.21060):
per block RMSNorm, the input projections x, z, B, C and dt, a depthwise
causal conv and SiLU on x, B and C, the SSD recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D x_t``
(computed by chunks: exact, any chunk size), the gated RMSNorm of
``y * silu(z)``, the out projection and a residual.  Its cache is the final
state and the conv windows.  No conv bias and no dt clamp (the
configuration lists these departures)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bench.reference.lm import NEG_INF, STACK, family_layers, rms_norm
from bench.reference.precision import Precision

MIXER = STACK + "mixer/"


def param_spec(model: dict) -> list:
    """(path, shape, dtype, init, scale) of the block leaves, stacked over
    the family's layers, after the mixer's norm."""
    d, L, pd = model["d_model"], family_layers(model), model["param_dtype"]
    di, ds, W = model["ssm_expand"] * d, model["ssm_state"], model["ssm_conv_width"]
    nh = di // model["ssm_head_dim"]
    m = MIXER
    return [(m + "w_x", (L, d, di), pd, "normal", None),
            (m + "w_z", (L, d, di), pd, "normal", None),
            (m + "w_b", (L, d, ds), pd, "normal", None),
            (m + "w_c", (L, d, ds), pd, "normal", None),
            (m + "w_dt", (L, d, nh), pd, "normal", None),
            (m + "conv_x", (L, W, di), pd, "normal", 0.5),
            (m + "conv_b", (L, W, ds), pd, "normal", 0.5),
            (m + "conv_c", (L, W, ds), pd, "normal", 0.5),
            (m + "a_log", (L, nh), "float32", "ssm_a", None),
            (m + "dt_bias", (L, nh), "float32", "ssm_dt", None),
            (m + "d_skip", (L, nh), "float32", "ones", None),
            (m + "norm", (L, di), "float32", "ones", None),
            (m + "w_out", (L, di, d), pd, "normal", None)]


def causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (b, S, C), kernel (W, C)."""
    W, S = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, j:j + S] * kernel[j] for j in range(W))


def ssd(x, dt, A, Bm, Cm, chunk: int, prec: Precision):
    """The SSD recurrence by chunks.  x (b, S, nh, P), dt (b, S, nh), A (nh,),
    Bm / Cm (b, S, N).  Returns (y (b, S, nh, P), final state (b, nh, P, N))."""
    b, S, nh, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    mm = prec.matmul
    state = x.new_zeros(b, nh, P, N)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, S, Q):
        xc, dtc = x[:, c0:c0 + Q], dt[:, c0:c0 + Q]
        bc, cc = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        acs = torch.cumsum(dtc * A, dim=1)                               # (b, Q, nh)
        seg = (acs[:, :, None, :] - acs[:, None, :, :]).permute(0, 3, 1, 2)  # (b, nh, q, k)
        decay = torch.exp(seg.masked_fill(~keep, NEG_INF))               # 0 above the diagonal
        scores = mm(cc, bc.transpose(1, 2))                              # (b, q, k)
        wts = scores[:, None] * decay * dtc.permute(0, 2, 1)[:, :, None, :]  # (b, nh, q, k)
        y = mm(wts, xc.permute(0, 2, 1, 3))                              # (b, nh, q, P)
        carried = mm(cc[:, None], state.transpose(-1, -2))              # (b, nh, q, P)
        y = y + carried * torch.exp(acs).permute(0, 2, 1)[..., None]
        to_end = torch.exp(acs[:, -1:] - acs) * dtc                     # (b, Q, nh)
        xs = (xc * to_end[..., None]).permute(0, 2, 3, 1)               # (b, nh, P, Q)
        state = state * torch.exp(acs[:, -1])[:, :, None, None] + mm(xs, bc[:, None])
        ys.append(y.permute(0, 2, 1, 3))
    return torch.cat(ys, dim=1), state


def mixer(p: Dict[str, torch.Tensor], i: int, h: torch.Tensor, model: dict, prec: Precision):
    """Mamba-2 mixer of normed h (b, S, d).  Returns (output (b, S, d),
    cache {state, conv_x, conv_b, conv_c})."""
    b, S, d = h.shape
    di, P, W = model["ssm_expand"] * d, model["ssm_head_dim"], model["ssm_conv_width"]
    nh = di // P
    mm = prec.matmul
    w = MIXER
    xp, z = mm(h, p[w + "w_x"][i]), mm(h, p[w + "w_z"][i])
    bp, cp = mm(h, p[w + "w_b"][i]), mm(h, p[w + "w_c"][i])
    dt_raw = mm(h, p[w + "w_dt"][i]) + p[w + "dt_bias"][i]
    dt = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))  # softplus, linear nowhere
    A = -torch.exp(p[w + "a_log"][i])
    xc = F.silu(causal_conv(xp, p[w + "conv_x"][i])).reshape(b, S, nh, P)
    bc = F.silu(causal_conv(bp, p[w + "conv_b"][i]))
    cc = F.silu(causal_conv(cp, p[w + "conv_c"][i]))
    y, state = ssd(xc, dt, A, bc, cc, model["ssm_chunk"], prec)
    y = (y + p[w + "d_skip"][i][:, None] * xc).reshape(b, S, di)
    y = rms_norm(y * F.silu(z), p[w + "norm"][i], model["rmsnorm_eps"])
    cache = {"state": state, "conv_x": xp[:, S - (W - 1):], "conv_b": bp[:, S - (W - 1):],
             "conv_c": cp[:, S - (W - 1):]}
    return mm(y, p[w + "w_out"][i]), cache


def block(p: Dict[str, torch.Tensor], i: int, x: torch.Tensor, h: torch.Tensor, model: dict,
          prec: Precision):
    """Layer i on the residual x (b, S, d), h its normed input.  Returns
    (new residual, cache {state, conv_x, conv_b, conv_c}, no loss readings)."""
    y, cache = mixer(p, i, h, model, prec)
    return x + y, cache, {}
