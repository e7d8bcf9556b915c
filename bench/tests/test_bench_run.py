"""A whole run of every cell, driven on the CPU at a tiny size (the look for
a card skipped): sound, it comes out correct; with the timed path broken
underneath, once for each fault the cell can have, it does not.  The cells'
limits are the committed ones."""

import time

import pytest
import torch

from bench.harness import program
from bench.harness.core import run_cell
from bench.tests import tiny_cell

TRAIN = ("mamba2-130m.train", "smollm-135m.train")
PREFILL = ("mamba2-130m.prefill", "smollm-135m.prefill")
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


def run(name: str, seconds: float = 0.3, trace: bool = False) -> dict:
    return run_cell(tiny_cell(name), SEED, seconds, trace, torch.device("cpu"),
                    time.perf_counter())


@pytest.mark.parametrize("name", TRAIN + PREFILL)
def test_a_sound_run_is_correct_and_reports_its_metrics(name):
    r = run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"


def test_a_traced_run_reports_per_layer_metrics_on_the_cpu():
    r = run("smollm-135m.train", trace=True)
    assert r["correct"]
    assert {"train_mfu", "idle_share.train", "launches_per_step.train"} <= set(r["metrics"])
    # no kernel ran on a device: no roofline is read, none is reported as 0
    assert "flash_roofline.train" not in r["metrics"]
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0


def _state_unchanged(make):
    def factory(cfg, opt):
        step = make(cfg, opt)

        def broken(params, state, batch):
            _, _, metrics = step(params, state, batch)
            return params, state, metrics

        return broken
    return factory


def _half_batch_train(make):
    def factory(cfg, opt):
        step = make(cfg, opt)

        def broken(params, state, batch):
            half = batch["tokens"].shape[0] // 2
            return step(params, state, {k: v[:half] for k, v in batch.items()})

        return broken
    return factory


def _half_batch_prefill(make):
    def factory(cfg):
        step = make(cfg)

        def broken(params, batch):
            half = batch["tokens"].shape[0] // 2
            logits, cache = step(params, {"tokens": batch["tokens"][:half]})
            twice = lambda t: torch.cat([t, t], dim=1)  # noqa: E731  (layers, batch, ...)
            return torch.cat([logits, logits]), {
                pos: {k: twice(v) for k, v in c.items()} for pos, c in cache.items()}

        return broken
    return factory


def _token_altered(make):
    def factory(cfg):
        step = make(cfg)

        def broken(params, batch):
            logits, cache = step(params, batch)
            logits = logits.clone()
            row = logits[0]
            second = torch.topk(row[:cfg.vocab_size], 2).indices[1]
            row[second] = row.max() + 1.0  # the second best served instead
            return logits, cache

        return broken
    return factory


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_train],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(program, "train_step", fault(program.train_step))
    r = run(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", PREFILL)
@pytest.mark.parametrize("fault", [_half_batch_prefill, _token_altered],
                         ids=["half_batch", "token_altered"])
def test_a_broken_prefill_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(program, "prefill_step", fault(program.prefill_step))
    r = run(name)
    assert not r["correct"], r["checks"]
