"""The SSD backward kernels' least time over their device time in a training
step: one backward call's work (``work``) times the calls, over every kernel
whose name holds ``ssd_bwd``.  A call is a launch of its first kernel
(``ssd_bwd_chunk_state``).  Nothing is read where no such kernel ran (a
backward that is not the kernels', such as the plain vjp)."""

from typing import Optional

from bench.work import BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, bound_s
from bench.work.kernels import ESIZE

KERNELS = "ssd_bwd"
FIRST = "ssd_bwd_chunk_state"


def work(B: int, S: int, nh: int, P: int, N: int, chunk: int, dtype: str) -> tuple:
    """(flops, bytes, bound seconds) of one backward call of the chunked SSD
    scan.  Bytes: x, dy, B and C read once in the model's dtype and dt once
    as float32; dx, dB and dC written once, ddt once as float32.  FLOPs, each
    product once at the tensor cores' rate for bf16: per (batch row, chunk)
    the causal halves of C B^T, dS B and dS^T C (the head-summed dS); per
    (row, head, chunk) the causal halves of dy x^T and W^T dy, and five
    (Q, P, N) products: the chunk state, dy H, dy^T C, B D^T and x D."""
    Q = min(chunk, S)
    pairs = Q * (Q + 1) // 2
    chunks = S // Q
    BH = B * nh
    flops = (B * chunks * 3 * 2 * pairs * N
             + BH * chunks * (2 * 2 * pairs * P + 5 * 2 * Q * P * N))
    esz = ESIZE[dtype]
    nbytes = 3 * BH * S * P * esz + 4 * B * S * N * esz + 2 * BH * S * 4
    peak = BF16_FLOPS_PER_S if esz == 2 else FP32_FLOPS_PER_S
    return flops, nbytes, bound_s(flops, nbytes, peak)


def read(run) -> Optional[float]:
    if run.trace is None:
        return None
    m, t = run.model, run.traffic
    S = t.get("seq_len", t.get("prompt_len"))
    P = m["ssm_head_dim"]
    nh = m["ssm_expand"] * m["d_model"] // P
    _, calls = run.trace.kernel_time(FIRST)
    spent, _ = run.trace.kernel_time(KERNELS)
    if not calls or spent <= 0:
        return None
    bound = work(t["batch"], S, nh, P, m["ssm_state"], m["ssm_chunk"], m["dtype"])[2]
    return 100.0 * calls * bound / spent
