"""streamtrace's span API and the LM path's spans, on the CPU.

* ``span()`` with no recorder active is the shared no-op context: it
  records nothing, reads no clock and asks nothing of the profiler.
* Spans nest and record on every thread, and inside an autograd
  Function's backward (the engine's own thread on a card).
* Under ``torch.profiler`` every recorded span is also a user annotation
  of the same name, as many times.
* A training step and a prefill of the reduced mamba2-130m and
  smollm-135m record the LM path's spans, as many times as the model makes
  those calls; outputs are bitwise the same with a recorder on and off.
* The recorder's clock anchor is exported, and a stream-path export still
  validates.
"""

import collections
import dataclasses
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.model import lm
from repro_torch.observability import (
    TraceRecorder,
    activate,
    chrome_trace,
    span,
    validate_chrome_trace,
)
from repro_torch.observability import recorder, spans
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.pytree import tree_leaves, tree_map

ARCHS = ["mamba2-130m", "smollm-135m"]


def _names(rec):
    return collections.Counter(e[2] for e in rec.events())


def test_no_recorder_no_work(monkeypatch):
    def boom(*a):
        raise AssertionError("a span with no recorder did work")

    rec = TraceRecorder()
    monkeypatch.setattr(spans, "time", SimpleNamespace(perf_counter_ns=boom))
    monkeypatch.setattr(spans, "torch", None)
    assert recorder.current() is None
    ctx = span("mixer")
    assert ctx is spans.NO_SPAN and span("loss") is ctx
    with ctx as got:
        assert got is None
    assert rec.total_events() == 0


def test_spans_nest_on_every_thread_and_the_autograd_engine():
    rec = TraceRecorder()

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with span("twice.backward"):
                return 2 * g

    def work(tag):
        with span(f"outer.{tag}"):
            with span(f"inner.{tag}"):
                time.sleep(0.001)

    with activate(rec):
        threads = [threading.Thread(target=work, args=(i,), name=f"worker-{i}") for i in range(3)]
        for t in threads:
            t.start()
        work("main")
        for t in threads:
            t.join(timeout=10)
        x = torch.ones(3, requires_grad=True)
        Twice.apply(x).sum().backward()
    assert not any(t.is_alive() for t in threads)
    assert x.grad.tolist() == [2.0, 2.0, 2.0]
    evs = {e[2]: e for e in rec.events()}
    for tag, thread in [(0, "worker-0"), (1, "worker-1"), (2, "worker-2"), ("main", "MainThread")]:
        outer, inner = evs[f"outer.{tag}"], evs[f"inner.{tag}"]
        assert outer[:2] == ("X", thread) and outer[3] == "lm"
        assert inner[:4] == ("X", thread, f"inner.{tag}", "lm")
        assert outer[4] <= inner[4] and inner[4] + inner[5] <= outer[4] + outer[5]
    assert evs["twice.backward"][0] == "X"
    assert len(rec.events()) == 9 and rec.drops() == {}


def _cfg(arch, remat="none"):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               param_dtype="float32", use_kernels="cuda", remat=remat)


def _step_and_prefill(cfg, rec=None):
    """One training step and one prefill of the same tokens from seed 0:
    (loss, (new parameters, AdamW's moments of the gradients), logits,
    cache)."""
    params = tree_map(lambda t: t.requires_grad_(True), lm.init_model(cfg, 0, device="cpu"))
    opt = OptConfig()
    state = init_opt_state(params, opt)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (2, 65), generator=g, dtype=torch.int32)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    with activate(rec):
        new, state, metrics = make_train_step(cfg, opt)(params, state, batch)
        logits, cache = make_prefill_step(cfg)(params, {"tokens": batch["tokens"]})
    return metrics["loss"], (new, state["m"], state["v"]), logits, cache


def _expected(cfg, remat):
    """The spans one step and one prefill of 64 tokens make.  The CE runs
    in one chunk, again in its checkpoint's recompute; ``head.backward``
    runs only on a card (``_HeadF32`` needs CUDA operands)."""
    L = cfg.num_layers
    ssm = sum(k.mixer == "ssm" for k in cfg.pattern()) * cfg.num_periods
    want = {"train.forward": 1, "train.backward": 1, "train.optimizer": 1, "loss": 2,
            "mixer": (2 * L if remat == "block" else L) + L,
            "prefill.forward": 1, "prefill.cache": 1}
    if ssm:
        want["ssd.backward"] = ssm
    return want


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_path_records_its_spans(arch, remat):
    cfg = _cfg(arch, remat)
    rec = TraceRecorder()
    _step_and_prefill(cfg, rec)
    assert dict(_names(rec)) == _expected(cfg, remat)
    assert ("ssd.backward" in _names(rec)) == (arch == "mamba2-130m")  # reaches SSDScan
    assert rec.drops() == {}


def test_head_backward_span():
    """``_HeadF32``'s backward, called as autograd calls it (its forward
    needs CUDA operands), records ``head.backward`` and nothing else."""
    h, w, g = torch.randn(4, 8), torch.randn(8, 16), torch.randn(4, 16)
    rec = TraceRecorder()
    with activate(rec):
        dh, dw = lm._HeadF32.backward(SimpleNamespace(saved_tensors=(h, w)), g)
    assert dict(_names(rec)) == {"head.backward": 1}
    assert torch.equal(dh, g @ w.t()) and torch.equal(dw, h.t() @ g)


@pytest.mark.parametrize("arch", ARCHS)
def test_profiler_mirrors_every_span(arch):
    cfg = _cfg(arch)
    rec = TraceRecorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _step_and_prefill(cfg, rec)
    annotated = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                    if e.is_user_annotation())
    assert annotated == _names(rec)


@pytest.mark.parametrize("arch", ARCHS)
def test_outputs_are_bitwise_the_same_with_a_recorder(arch):
    cfg = _cfg(arch)
    off = _step_and_prefill(cfg)
    rec = TraceRecorder()
    on = _step_and_prefill(cfg, rec)
    assert rec.total_events() > 0
    for a, b in zip(tree_leaves(off), tree_leaves(on)):
        assert torch.equal(a, b)


def test_clock_anchor_is_exported_and_stream_exports_validate():
    import repro_torch
    from repro_torch.apps.streams import topfilter

    before = time.time_ns()
    rec = TraceRecorder()
    pc, unix = rec.clock_anchor
    assert pc == rec.t0_ns and before <= unix <= time.time_ns()
    with activate(rec), span("mixer"):
        pass
    payload = chrome_trace(rec)
    assert payload["otherData"]["clock_anchor"] == {"perf_counter_ns": pc, "time_ns": unix}
    assert validate_chrome_trace(payload) == []

    net, _ = topfilter(64)
    rep = repro_torch.compile(net, block=16, device="cpu").run(trace=True)
    assert set(rep.trace["otherData"]["clock_anchor"]) == {"perf_counter_ns", "time_ns"}
    assert validate_chrome_trace(rep.trace, require_cats=["run"]) == []
