"""Operations and bytes of each hand-written kernel's work, from its shape:
the causal flash forward and backward, the three-kernel SSD scan and
RMSNorm.

Each input is counted as read once and each output as written once,
whatever the kernel reads again, and the operations are those the function
needs (the causal half of a square product, not the masked half).
"""

from __future__ import annotations

from bench.work import BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, bound_s

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _peak(dtype: str) -> float:
    return BF16_FLOPS_PER_S if ESIZE[dtype] == 2 else FP32_FLOPS_PER_S


def flash(B: int, S: int, H: int, KV: int, hd: int, dtype: str, causal: bool = True) -> dict:
    """{pass: (flops, bytes, bound seconds)} of one forward and of one
    backward over a (B, S, H, hd) query and (B, S, KV, hd) keys and values.

    The forward needs QK^T and PV over the (query, key) pairs.  The backward
    needs five products over them, whichever kernels compute them: the
    scores QK^T again, dO.V^T, dV = P^T.dO, dQ = dS.K and dK = dS^T.Q.  So a
    backward split into a dQ and a dK/dV kernel, each computing the scores
    and dO.V^T for itself, is held to the five products once."""
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S  # (query, key) pairs
    esz = ESIZE[dtype]
    q_b, kv_b, row_b = B * H * S * hd * esz, B * KV * S * hd * esz, B * H * S * 4
    work = {
        "forward": (4 * pairs * hd, 2 * q_b + 2 * kv_b + row_b),         # q, k, v in; o, lse out
        "backward": (10 * pairs * hd, 4 * q_b + 4 * kv_b + row_b),       # q, o, dO, k, v, lse in;
    }                                                                    # dq, dk, dv out
    return {k: (f, b, bound_s(f, b, _peak(dtype))) for k, (f, b) in work.items()}


def ssd_scan(B: int, S: int, nh: int, P: int, N: int, chunk: int, dtype: str) -> tuple:
    """(flops, bytes, bound seconds) of one chunked SSD scan call.  The C.B^T
    scores (the causal half of a Q x Q product) do not depend on the head and
    count once per (batch row, chunk); the W.x product (causal half), the
    carried state's contribution and the state update count per (row, head,
    chunk).  The products are taken at the tensor cores' rate for bf16."""
    Q = min(chunk, S)
    pairs = Q * (Q + 1) // 2
    chunks = S // Q
    flops = B * chunks * 2 * pairs * N + B * nh * chunks * (2 * pairs * P + 4 * Q * P * N)
    esz = ESIZE[dtype]
    BH = B * nh
    # x in, y out; dt and da (float32) in; B and C in; the final float32 state out
    nbytes = 2 * BH * S * P * esz + 2 * BH * S * 4 + 2 * B * S * N * esz + BH * P * N * 4
    return flops, nbytes, bound_s(flops, nbytes, _peak(dtype))


def rmsnorm(R: int, d: int, dtype: str) -> tuple:
    """(flops, bytes, bound seconds) of one RMSNorm launch over R rows of d:
    the rows read and written once, the float32 scale read once, four
    float32 operations an element."""
    flops = 4 * R * d
    nbytes = 2 * R * d * ESIZE[dtype] + 4 * d
    return flops, nbytes, bound_s(flops, nbytes, FP32_FLOPS_PER_S)
