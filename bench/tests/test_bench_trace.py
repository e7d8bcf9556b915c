"""The trace's reduction and the per-layer readers, on events made by hand:
the window's device activities are those launched inside it, overlapping
activities count once, idle gaps are labelled by what the host was doing
and the program span it was in, the traced window's credit reaches the
span readers, and a reader that finds nothing, or reads a window that lost
records, returns nothing."""

import json
from types import SimpleNamespace

import pytest
import torch

from bench.harness import cells, readers, spans
from bench.harness.trace import Trace, Tracer, reduce
from bench.tests import ROOT
from bench.tests.test_bench_spans import _no_device, events as two_steps
from bench.work import kernels


def events():
    """Two training steps in a 10 s window.  kB overlaps kA; a copy runs
    between the steps; the second kA, launched inside the window, is
    stamped past its end (the device's stamps can run late) and counts
    whole; kC was launched and ran before the window."""
    device = [("kA", 1.0, 3.0, True), ("kB", 2.0, 4.0, True), ("Memcpy HtoD", 6.0, 7.0, False),
              ("kA", 9.5, 12.0, True), ("kC", -2.0, -1.0, True)]
    launch = {1: (0.4, "cudaLaunchKernel"), 2: (0.6, "cudaLaunchKernel"),
              3: (5.6, "cudaMemcpyAsync"), 4: (8.0, "cudaLaunchKernel"),
              5: (-2.5, "cudaLaunchKernel"), 6: (9.8, "cudaDeviceSynchronize")}
    return {
        "spans": [("window", 0.0, 10.0), ("train_step", 0.0, 4.0), ("train_step", 5.0, 9.0)],
        "device": device, "corr": [1, 2, 3, 4, 5], "launch": launch,
        "host": [(0.5, "aten::mm"), (4.5, "aten::add"), (5.5, "aten::copy_")],
        "program": [("train.forward", 0.2, 2.0), ("mixer", 0.3, 0.8),
                    ("train.backward", 6.5, 8.0), ("ssd.backward", 6.8, 7.5)],
    }


def test_busy_is_the_union_of_device_intervals_in_the_window():
    t = reduce(events())
    assert t.window_s == 10.0
    assert t.busy_s == pytest.approx(3.0 + 1.0 + 2.5)
    assert sorted(t.kernels) == [("kA", 2.0), ("kA", 2.5), ("kB", 2.0)]
    assert t.device_ops[0] == ("kA", 4.5)
    assert t.launch_calls == 3                                        # kC's was before it
    assert t.late_s == pytest.approx(2.0)


def test_idle_gaps_are_labelled_by_the_host_span_and_operation():
    gaps = dict(reduce(dict(events(), program=[])).idle_gaps)
    assert gaps["train_step: nothing"] == pytest.approx(1.0)          # 0..1
    assert gaps["between calls: aten::mm"] == pytest.approx(2.0)       # 4..6
    assert gaps["train_step: aten::copy_"] == pytest.approx(2.5)       # 7..9.5


def test_idle_gaps_carry_the_innermost_program_span():
    gaps = dict(reduce(events()).idle_gaps)
    assert gaps == pytest.approx({"train_step: nothing": 1.0,  # before train.forward
                                  "between calls: aten::mm": 2.0,
                                  "train_step > ssd.backward: aten::copy_": 2.5})


def test_a_trace_needs_exactly_one_window():
    ev = events()
    ev["spans"].append(("window", 20.0, 21.0))
    with pytest.raises(RuntimeError):
        reduce(ev)


def _run(kind, trace, calls=2, cell="smollm-135m", traced=2, credit=None):
    from bench.harness.core import driver

    model = json.loads((ROOT / f"bench/configs/{cell}.json").read_text())["model"]
    traffic = {"kind": kind, "batch": 8, "seq_len": 2048, "prompt_len": 2048}
    return SimpleNamespace(model=dict(model, remat="block"), traffic=traffic, trace=trace,
                           spans=credit, driver=driver(kind),
                           window={"calls": calls, "seconds": 2.0, "tokens": calls * 16384,
                                   "ttft_s": [0.01 * i for i in range(1, 101)]},
                           traced={"calls": traced} if trace is not None else {})


SPAN_READERS = ("ssd_bwd_ms.train", "loss_ms.train", "optimizer_ms.train", "mixer_ms.prefill")


def _traced():
    return Trace(window_s=10.0, busy_s=5.5, kernels=[], device_ops=[], idle_gaps=[])


def test_the_traced_windows_credit_reaches_the_span_readers():
    run = _run("train", _traced(), credit=spans.credit(two_steps()))
    got = {name: cells.metric_reader(name)(run) for name in SPAN_READERS}
    # per step: ssd.backward kB and a copy 1 s, train.optimizer kD 0.5 s, mixer kA 0.5 s;
    # no loss span in these steps
    assert got == pytest.approx({"ssd_bwd_ms.train": 1000.0, "loss_ms.train": None,
                                 "optimizer_ms.train": 500.0, "mixer_ms.prefill": 500.0})


@pytest.mark.parametrize("lose, dropped", [(None, {"MainThread": 3}), (_no_device, None)],
                         ids=["recorder_dropped", "record_lost"])
def test_a_span_reader_reads_nothing_from_a_flagged_window(lose, dropped):
    ev = two_steps()
    if lose is not None:
        lose(ev)
    cr = spans.credit(ev, dropped=dropped)
    assert cr.faults()
    assert any(line.startswith("LOST RECORDS: ") for line in spans.table(cr, 2).splitlines())
    run = _run("train", _traced(), credit=cr)
    assert all(cells.metric_reader(name)(run) is None for name in SPAN_READERS)


def test_a_traced_window_records_the_programs_spans():
    from repro_torch.observability import span

    cpu = torch.device("cpu")
    tracer = Tracer(True, cpu)
    with tracer.window():
        with tracer.span("train_step"), span("train.forward"), span("mixer"):
            torch.ones(64).add_(1)
    with span("mixer"):  # no recorder outside the window
        pass
    assert {"train.forward", "mixer", spans.OUTSIDE} == set(tracer.spans.by_span)
    assert tracer.spans.faults() == [] and tracer.trace.window_s > 0


def test_readers_return_nothing_without_a_trace_or_a_kernel():
    empty = Trace(window_s=1.0, busy_s=0.5, kernels=[("other", 0.1)], device_ops=[],
                  idle_gaps=[])
    for read in (readers.flash_roofline, readers.rmsnorm_roofline, readers.idle_share,
                 readers.launches_per_call, lambda run: readers.span_ms(run, "mixer")):
        assert read(_run("train", None)) is None
    for read in (readers.flash_roofline, readers.rmsnorm_roofline,
                 lambda run: readers.span_ms(run, "mixer")):
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
