"""``ssd_bwd_roofline.train``: one backward call's least time times the calls
(launches of its first kernel) over the time of every ``ssd_bwd`` kernel;
the forward's kernels are not counted, and nothing is read without a trace
or without a backward kernel."""

import pytest

from bench.harness import cells
from bench.harness.trace import Trace
from bench.tests.test_bench_trace import _run

READ = cells.metric_reader("ssd_bwd_roofline.train")


def _work():
    import importlib.util

    from bench.tests import ROOT

    spec = importlib.util.spec_from_file_location(
        "ssd_bwd_roofline", ROOT / "bench/metrics/ssd_bwd_roofline.train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.work


def test_the_count_at_the_training_cell():
    flops, nbytes, bound = _work()(24, 2048, 24, 64, 128, 256, "bfloat16")
    assert flops == pytest.approx(1.403e11, rel=1e-3)
    assert nbytes == 3 * 576 * 2048 * 64 * 2 + 4 * 24 * 2048 * 128 * 2 + 2 * 576 * 2048 * 4
    assert bound == pytest.approx(nbytes / 3.35e12)  # bytes bound it


def test_reads_the_backward_kernels_alone():
    bound = _work()(8, 2048, 24, 64, 128, 256, "bfloat16")[2]
    # two traced steps of 24 calls, five kernels a call, beside the forward's three
    ks = []
    for _ in range(48):
        ks += [("ssd_bwd_chunk_state_kernel<true>", 2 * bound),
               ("ssd_bwd_state_pass_kernel", bound), ("ssd_bwd_keys_kernel<true>", 3 * bound),
               ("ssd_bwd_queries_kernel<true>", 3 * bound), ("ssd_bwd_dda_kernel", bound)]
        ks += [("ssd_chunk_state_kernel<true>", 1.0), ("ssd_state_pass_kernel", 1.0),
               ("ssd_chunk_out_kernel<true>", 1.0)]
    t = Trace(window_s=1.0, busy_s=0.5, kernels=ks, device_ops=[], idle_gaps=[])
    assert READ(_run("train", t, cell="mamba2-130m")) == pytest.approx(10.0)


def test_reads_nothing_without_a_trace_or_a_backward_kernel():
    assert READ(_run("train", None, cell="mamba2-130m")) is None
    plain = Trace(window_s=1.0, busy_s=0.5, kernels=[("ssd_chunk_out_kernel<true>", 1.0),
                                                     ("elementwise_kernel", 0.1)],
                  device_ops=[], idle_gaps=[])
    assert READ(_run("train", plain, cell="mamba2-130m")) is None
