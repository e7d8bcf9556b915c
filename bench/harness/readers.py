"""The arithmetic of the metric readers under ``metrics/``: each reader file
binds one of these to its metric's name.  A reader takes the run
(``core.Run``) and returns a number, or ``None`` where it finds nothing to
read (a trace in an untraced run, a kernel that did not run).  A share of a
roofline or a peak is never returned as 0 for nothing read.

Rates and the model FLOP share are read from the measured window, which is
never traced; what needs the trace (busy time, launches, kernel times, the
device time of the program's spans) is read from the traced calls after it
and counted per traced call."""

from __future__ import annotations

import math
from typing import Optional

from bench.harness import spans
from bench.work import BF16_FLOPS_PER_S, kernels, model as model_work

FLASH_FWD = "flash_fwd"
FLASH_BWD = ("flash_bwd_dq", "flash_bwd_dkv")  # one backward: a dQ and a dK/dV launch
SSD = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")  # one bf16 call's kernels


def setup_s(run) -> float:
    return run.setup_s


def tokens_per_s(run) -> float:
    """Tokens of every call completed in the window over the window."""
    return run.window["tokens"] / run.window["seconds"]


def ttft_p95_ms(run) -> float:
    """Nearest-rank 95th percentile of every request's time to first token."""
    t = sorted(run.window["ttft_s"])
    return t[math.ceil(0.95 * len(t)) - 1] * 1e3


def _shape(run):
    t = run.traffic
    return t["batch"], t.get("seq_len", t.get("prompt_len"))


def mfu(run) -> Optional[float]:
    """Model FLOPs of the calls completed in the measured window over the
    window's seconds and the bf16 peak, in %."""
    if not run.window.get("calls"):
        return None
    B, S = _shape(run)
    flops = run.driver.FLOPS(run.model, B, S)
    return 100.0 * flops * run.window["calls"] / run.window["seconds"] / BF16_FLOPS_PER_S


def _traced_calls(run) -> int:
    return run.traced.get("calls", 0) if run.trace is not None else 0


def idle_share(run) -> Optional[float]:
    """1 - device busy (the union of its activities) over the traced
    window, in %."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def launches_per_call(run) -> Optional[float]:
    """Kernels the device ran in the traced window per traced call."""
    calls = _traced_calls(run)
    return len(run.trace.kernels) / calls if calls else None


def flash_roofline(run) -> Optional[float]:
    """Least time of the flash forwards' and backwards' work over the time
    of every flash launch, in %.  A backward is one dQ and one dK/dV launch,
    held to the five products it needs once (``kernels.flash``)."""
    if run.trace is None:
        return None
    m = run.model
    B, S = _shape(run)
    bounds = kernels.flash(B, S, m["num_heads"], m["num_kv_heads"], m["head_dim"], m["dtype"])
    fwd_s, n_fwd = run.trace.kernel_time(FLASH_FWD)
    dq_s, n_dq = run.trace.kernel_time(FLASH_BWD[0])
    dkv_s, n_dkv = run.trace.kernel_time(FLASH_BWD[1])
    if n_dq != n_dkv:  # a backward's work is not known
        return None
    spent = fwd_s + dq_s + dkv_s
    least = n_fwd * bounds["forward"][2] + n_dq * bounds["backward"][2]
    return 100.0 * least / spent if spent > 0 else None


def ssd_scan_roofline(run) -> Optional[float]:
    """Least time of every SSD scan call's work over its three kernels' time."""
    if run.trace is None:
        return None
    m = run.model
    B, S = _shape(run)
    P = m["ssm_head_dim"]
    nh = m["ssm_expand"] * m["d_model"] // P
    bound = kernels.ssd_scan(B, S, nh, P, m["ssm_state"], m["ssm_chunk"], m["dtype"])[2]
    _, calls = run.trace.kernel_time(SSD[0])
    spent, _ = run.trace.kernel_time(*SSD)
    return 100.0 * calls * bound / spent if spent > 0 else None


def rmsnorm_roofline(run) -> Optional[float]:
    """Least time of the RMSNorm launches' work over their time, in %.  The
    launches' shapes are the model's (``model.rmsnorm_launches``); where the
    trace holds another count, their work is not known: nothing read."""
    calls = _traced_calls(run)
    if not calls:
        return None
    B, S = _shape(run)
    per_call = model_work.rmsnorm_launches(run.model, B * S, run.driver.BACKWARD)
    spent, n = run.trace.kernel_time("rmsnorm_kernel")
    if n != len(per_call) * calls or spent <= 0:
        return None
    least = sum(kernels.rmsnorm(*shape)[2] for shape in per_call) * calls
    return 100.0 * least / spent


def span_ms(run, *names: str) -> Optional[float]:
    """Device ms per traced call credited to the program spans ``names``
    (self time, ``spans.span_ms``): nothing where the window lost records."""
    return spans.span_ms(run.spans, _traced_calls(run), *names)
