"""Crediting device work to the program's spans, on events made by hand:
work goes to the innermost span open at its launch (found by correlation
id), whichever thread opened it; the table sums to the device's total; a
lost record and a span whose kernels differ between calls are flagged; a
reader whose span is absent reads nothing."""

import pytest
import torch

from bench.harness import spans

STEP = [  # (launch, device start, device end, kernel, name of the launching call)
    (0.3, 0.5, 1.0, True, "cudaLaunchKernel"),      # kA: mixer inside train.forward
    (1.3, 2.0, 2.5, True, "cudaLaunchKernel"),      # kB: ssd.backward, run after it closed
    (1.4, 2.5, 3.0, False, "cudaMemcpyAsync"),      # a copy in ssd.backward
    (2.2, 3.0, 3.5, True, "cuLaunchKernelEx"),      # kC: train.backward, outside the SSD span
    (3.2, 3.5, 4.0, True, "cudaLaunchKernel"),      # kD: train.optimizer
]


def events():
    """Two training steps, at 0 and at 5, in a 10 s window.  In each, the
    forward launches kA in a mixer; the backward's engine thread opens
    ``ssd.backward`` while the main thread waits in ``train.backward``, and
    launches kB and a copy there; kC is launched in the backward outside
    the SSD span; the optimizer launches kD.  kE is launched between the
    steps and runs past the window's end; kZ runs before the window."""
    program, device, corr, launch = [], [], [], {}
    for t0 in (0.0, 5.0):
        program += [("train.forward", t0, t0 + 1.0), ("mixer", t0 + 0.2, t0 + 0.5),
                    ("train.backward", t0 + 1.0, t0 + 3.0),
                    ("ssd.backward", t0 + 1.2, t0 + 1.6), ("train.optimizer", t0 + 3.0, t0 + 3.5)]
        for t, s, e, k, call in STEP:
            c = 100 + len(corr)
            device.append(("k", t0 + s, t0 + e, k))
            corr.append(c)
            launch[c] = (t0 + t, call)
    for t, s, e, c in [(9.2, 9.5, 12.0, 90), (-3.0, -2.0, -1.0, 91)]:
        device.append(("k", s, e, True))
        corr.append(c)
        launch[c] = (t, "cudaLaunchKernel")
    launch[92] = (4.5, "cudaStreamSynchronize")  # launches nothing
    return {
        "spans": [("window", 0.0, 10.0), ("train_step", 0.0, 4.2), ("train_step", 5.0, 9.2)],
        "device": device, "program": program, "corr": corr, "launch": launch,
    }


def test_work_is_credited_to_the_innermost_span_at_its_launch():
    cr = spans.credit(events())
    assert cr.by_span["mixer"] == [1.0, 2]                   # kA
    assert cr.by_span["train.forward"] == [0.0, 0]           # self time only
    assert cr.by_span["ssd.backward"] == [2.0, 2]            # kB and the copy (not a kernel)
    assert cr.by_span["train.backward"] == [1.0, 2]          # kC
    assert cr.by_span["train.optimizer"] == [1.0, 2]         # kD
    assert cr.by_span[spans.OUTSIDE] == [0.5, 1]             # kE, clipped at the window
    assert cr.faults() == []


def test_the_table_sums_to_the_device_total():
    cr = spans.credit(events())
    assert sum(s for s, _ in cr.by_span.values()) == pytest.approx(cr.device_s)
    assert cr.device_s == pytest.approx(5.5)
    text = spans.table(cr, calls=2)
    assert "ssd.backward" in text and "2750.000" in text     # 5.5 s over 2 calls
    assert "LOST" not in text


def _no_launch(ev):
    """The profiler lost kC's launch in the second step."""
    del ev["launch"][ev["corr"][8]]


def _no_device(ev):
    """The profiler lost kD's device record in the second step."""
    del ev["device"][9], ev["corr"][9]


def _late(ev):
    """kD's device record in the second step is stamped after the window."""
    ev["device"][9] = ("k", 10.5, 11.0, True)


def _more_work(ev):
    """The first step's optimizer launched one kernel more."""
    ev["device"].append(("k", 3.9, 4.0, True))
    ev["corr"].append(93)
    ev["launch"][93] = (3.3, "cudaLaunchKernel")


@pytest.mark.parametrize("fault, want", [
    (_no_launch, ["1 device activities with no launching call in the trace",
                  "train.backward in train_step: kernels per call differ [1, 0]"]),
    (_no_device, ["1 kernel launches in the window with no device activity in it",
                  "train.optimizer in train_step: kernels per call differ [1, 0]"]),
    (_late, ["1 kernel launches in the window with no device activity in it",
             "train.optimizer in train_step: kernels per call differ [1, 0]"]),
    (_more_work, ["train.optimizer in train_step: kernels per call differ [2, 1]"]),
], ids=["no_launch", "no_device", "late", "uneven"])
def test_lost_records_are_flagged(fault, want):
    ev = events()
    fault(ev)
    cr = spans.credit(ev)
    assert cr.faults() == want
    assert sum(s for s, _ in cr.by_span.values()) == pytest.approx(cr.device_s)
    assert spans.table(cr, calls=2).splitlines()[-len(want):] == [f"LOST RECORDS: {w}" for w in want]


@pytest.mark.parametrize("read", [
    lambda cr: spans.span_ms(cr, 2, "ssd.backward"),
    lambda cr: spans.span_kernels(cr, 2, "ssd.backward"),
    lambda cr: spans.span_ms(cr, 2, "loss", "head.backward"),
    lambda cr: spans.span_ms(cr, 2, "train.optimizer"),
    lambda cr: spans.span_ms(cr, 2, "mixer"),
    lambda cr: spans.span_ms(cr, 2, "prefill.cache"),
], ids=["ssd_bwd_ms", "ssd_bwd_launches", "loss_ms", "optimizer_ms", "mixer_ms", "cache_ms"])
def test_a_reader_whose_span_is_absent_reads_nothing(read):
    assert read(None) is None
    assert read(spans.credit(dict(events(), program=[]))) is None


def test_readers_divide_by_the_calls():
    cr = spans.credit(events())
    assert spans.span_ms(cr, 2, "ssd.backward") == pytest.approx(1000.0)
    assert spans.span_kernels(cr, 2, "ssd.backward") == 1.0
    assert spans.span_ms(cr, 2, "train.optimizer", "loss") == pytest.approx(500.0)
    assert spans.span_ms(cr, 0, "ssd.backward") is None


def test_raw_events_keep_the_program_spans_of_a_profiled_run():
    from repro_torch.observability import TraceRecorder, activate, span

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window"), activate(TraceRecorder()):
            with torch.profiler.record_function("train_step"), span("train.forward"):
                with span("mixer"):
                    torch.ones(4).add_(1)
    ev = spans.raw_events(prof)
    assert sorted(n for n, _, _ in ev["program"]) == ["mixer", "train.forward"]
    assert ev["corr"] == [] and ev["device"] == []
    cr = spans.credit(ev)
    assert cr.device_s == 0.0 and cr.by_span["mixer"] == [0.0, 0] and cr.faults() == []
