"""The trace's reduction and the per-layer readers, on events made by hand:
overlapping device activities count once, idle gaps are labelled by what
the host was doing, and a reader that finds nothing returns nothing."""

import json
from types import SimpleNamespace

import pytest

from bench.harness import readers
from bench.harness.trace import Trace, reduce
from bench.tests import ROOT
from bench.work import kernels


def events():
    return {
        "spans": [("window", 0.0, 10.0), ("train_step", 0.0, 4.0), ("train_step", 5.0, 9.0)],
        "device": [("kA", 1.0, 3.0, True), ("kB", 2.0, 4.0, True),   # overlap: busy 1..4
                   ("Memcpy HtoD", 6.0, 7.0, False),
                   ("kA", 9.5, 12.0, True),                          # clipped at the window
                   ("kC", -2.0, -1.0, True)],                        # outside the window
        "host": [(0.5, "aten::mm"), (4.5, "aten::add"), (5.5, "aten::copy_")],
        "launches": 4,
    }


def test_busy_is_the_union_of_device_intervals_in_the_window():
    t = reduce(events())
    assert t.window_s == 10.0
    assert t.busy_s == pytest.approx(3.0 + 1.0 + 0.5)
    assert sorted(t.kernels) == [("kA", 0.5), ("kA", 2.0), ("kB", 2.0)]
    assert t.device_ops[0] == ("kA", 2.5)
    assert t.launch_calls == 4


def test_idle_gaps_are_labelled_by_the_host_span_and_operation():
    gaps = dict(reduce(events()).idle_gaps)
    assert gaps["train_step: nothing"] == pytest.approx(1.0)          # 0..1
    assert gaps["between calls: aten::mm"] == pytest.approx(2.0)       # 4..6
    assert gaps["train_step: aten::copy_"] == pytest.approx(2.5)       # 7..9.5


def test_a_trace_needs_exactly_one_window():
    ev = events()
    ev["spans"].append(("window", 20.0, 21.0))
    with pytest.raises(RuntimeError):
        reduce(ev)


def _run(kind, trace, calls=2, cell="smollm-135m", traced=2):
    from bench.harness.core import driver

    model = json.loads((ROOT / f"bench/configs/{cell}.json").read_text())["model"]
    traffic = {"kind": kind, "batch": 8, "seq_len": 2048, "prompt_len": 2048}
    return SimpleNamespace(model=dict(model, remat="block"), traffic=traffic, trace=trace,
                           driver=driver(kind),
                           window={"calls": calls, "seconds": 2.0, "tokens": calls * 16384,
                                   "ttft_s": [0.01 * i for i in range(1, 101)]},
                           traced={"calls": traced} if trace is not None else {})


def test_readers_return_nothing_without_a_trace_or_a_kernel():
    empty = Trace(window_s=1.0, busy_s=0.5, kernels=[("other", 0.1)], device_ops=[],
                  idle_gaps=[])
    for read in (readers.flash_roofline, readers.rmsnorm_roofline, readers.f32_gemm_ms,
                 readers.idle_share, readers.launches_per_call):
        assert read(_run("train", None)) is None
    for read in (readers.flash_roofline, readers.rmsnorm_roofline, readers.f32_gemm_ms):
        assert read(_run("train", empty)) is None
    assert readers.ssd_scan_roofline(_run("train", empty, cell="mamba2-130m")) is None
    assert readers.idle_share(_run("train", empty)) == pytest.approx(50.0)
    assert readers.mfu(_run("train", None, calls=0)) is None


def test_roofline_readers_divide_the_least_time_by_the_measured():
    bounds = kernels.flash(8, 2048, 9, 3, 64, "bfloat16")
    fwd, bwd = bounds["forward"][2], bounds["backward"][2]
    # two traced steps under block remat: 60 forwards and 30 backwards a step
    ks = ([("flash_fwd_wgmma_kernel<64>", 2 * fwd)] * 120
          + [("flash_bwd_dq_wgmma_kernel<64>", 0.8 * bwd)] * 60
          + [("flash_bwd_dkv_wgmma_kernel<64>", 1.2 * bwd)] * 60)
    norm = kernels.rmsnorm(16384, 576, "bfloat16")[2]
    ks += [("rmsnorm_kernel<bf16>", 4 * norm)] * 242
    ks += [("ampere_sgemm_128x64_tn", 0.003)] * 4
    t = Trace(window_s=1.0, busy_s=0.5, kernels=ks, device_ops=[], idle_gaps=[])
    run = _run("train", t, calls=10)
    assert readers.flash_roofline(run) == pytest.approx(50.0)
    assert readers.rmsnorm_roofline(run) == pytest.approx(25.0)   # 121 launches a step
    assert readers.f32_gemm_ms(run) == pytest.approx(6.0)
    assert readers.launches_per_call(run) == len(ks) / 2           # per traced step
    t.kernels.append(("rmsnorm_kernel<bf16>", norm))               # a count not the model's
    assert readers.rmsnorm_roofline(run) is None
    t.kernels.append(("flash_bwd_dq_wgmma_kernel<64>", bwd))       # a backward's half
    assert readers.flash_roofline(run) is None


def test_mfu_is_read_from_the_measured_window():
    from bench.work import BF16_FLOPS_PER_S, model

    run = _run("train", None, calls=3)
    m = run.model
    want = 100.0 * 3 * model.train_flops(m, 8, 2048) / 2.0 / BF16_FLOPS_PER_S
    assert readers.mfu(run) == pytest.approx(want)
    run = _run("prefill", None, calls=3)
    assert readers.mfu(run) == pytest.approx(
        100.0 * 3 * model.prefill_flops(m, 8, 2048) / 2.0 / BF16_FLOPS_PER_S)


def test_end_to_end_readers():
    run = _run("prefill", None, calls=3)
    assert readers.tokens_per_s(run) == 3 * 16384 / 2.0
    assert readers.ttft_p95_ms(run) == pytest.approx(950.0)  # the 95th of 100 by rank
