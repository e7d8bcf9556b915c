"""An untied output head (``tie_embeddings`` false): the frame gives the
head a leaf ``head/w`` (d, padded vocabulary) of its own, at the port's path
and shape, and an untied smollm-135m tiny cell runs correct through the port
in training and in prefill; a program that multiplies by the embedding in
the head's place is not correct.  A tied configuration's leaves are those
before the head leaf existed, so its weights from a seed are the same."""

import time

import pytest
import torch

from bench.harness import program
from bench.harness.core import run_cell
from bench.harness.weights import make_weights
from bench.reference.lm import padded_vocab, param_spec
from bench.tests import tiny_cell

CELLS = ("smollm-135m.train", "smollm-135m.prefill")
SEED = 2 ** 31 + 4242


def untied(name: str) -> dict:
    cell = tiny_cell(name)
    cell["config"]["model"]["tie_embeddings"] = False
    return cell


def run(cell: dict) -> dict:
    return run_cell(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter())


def test_the_head_leaf_is_added_last_only_where_untied():
    model = untied("smollm-135m.train")["config"]["model"]
    tied = dict(model, tie_embeddings=True)
    d, pd = model["d_model"], model["param_dtype"]
    assert param_spec(model)[:-1] == param_spec(tied)
    assert param_spec(model)[-1] == ("head/w", (d, padded_vocab(model)), pd, "normal", None)
    assert all(path != "head/w" for path, *_ in param_spec(tied))


@pytest.mark.parametrize("name", CELLS)
def test_an_untied_head_runs_correct_through_the_port(name):
    cell = untied(name)
    model = cell["config"]["model"]
    flat = make_weights(model, 3, torch.device("cpu"))
    program.check_layout(program.model_config(model), flat)  # the port has head/w too
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_a_program_that_multiplies_by_the_embedding_is_not_correct(name, monkeypatch):
    program._port()
    from repro_torch.model import lm as port_lm

    monkeypatch.setattr(port_lm, "_head_w", lambda params: params["embed"]["tok"].t())
    r = run(untied(name))
    assert not r["correct"], r["checks"]
