"""The flash roofline of a prefill: a forward-only trace is held to the
forward's bound alone, and the metric's reader is found by name."""

import pytest

from bench.harness import cells, readers
from bench.harness.trace import Trace
from bench.tests.test_bench_trace import _run
from bench.work import kernels


def test_a_forward_only_trace_reads_the_forwards_bound_over_their_time():
    fwd = kernels.flash(8, 2048, 9, 3, 64, "bfloat16")["forward"][2]
    # two traced requests of a 30-layer model: 60 forwards, no dQ or dK/dV
    ks = [("flash_fwd_wgmma_kernel<64>", 4 * fwd)] * 60 + [("rmsnorm_kernel<bf16>", 1e-5)] * 122
    run = _run("prefill", Trace(window_s=1.0, busy_s=0.5, kernels=ks, device_ops=[],
                                idle_gaps=[]))
    assert readers.flash_roofline(run) == pytest.approx(25.0)
    empty = Trace(window_s=1.0, busy_s=0.5, kernels=ks[60:], device_ops=[], idle_gaps=[])
    assert readers.flash_roofline(_run("prefill", empty)) is None  # no flash kernel ran


def test_the_prefill_reader_is_found_by_name():
    assert cells.metric_reader("flash_roofline.prefill") is readers.flash_roofline
