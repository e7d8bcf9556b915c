"""The reference's training objective: a family's own loss terms reach its
gradients and add up over the blocks of rows the reference takes, and a
family that reads nothing (``dense``, ``ssm``) trains on the cross-entropy
alone, to the bit as before the terms existed."""

import sys
import types

import pytest
import torch
import torch.nn.functional as F

from bench.harness.train import _loss_and_grads
from bench.harness.weights import make_weights
from bench.reference import dense, lm
from bench.reference.precision import Precision
from bench.tests import tiny_cell

WEIGHT = 0.5


def toy_family() -> types.ModuleType:
    """The dense block, reading each row's mean square of its output, and a
    loss term of that reading summed over layers and rows over the batch's
    B: a share per block of rows that adds up to the batch's term."""
    toy = types.ModuleType("bench.reference.toy")
    toy.param_spec = dense.param_spec

    def block(p, i, x, h, model, prec):
        x, cache, _ = dense.block(p, i, x, h, model, prec)
        return x, cache, {"square": (x * x).mean(-1).sum(-1)}

    def loss_terms(terms, model, batch):
        return WEIGHT * torch.stack(terms["square"]).sum() / batch[0]

    toy.block, toy.loss_terms = block, loss_terms
    return toy


def setup(name: str, batch: int = 3):
    cell = tiny_cell(name)
    model, t = cell["config"]["model"], cell["traffic"]
    params = make_weights(model, 7, torch.device("cpu"))
    g = torch.Generator().manual_seed(11)
    ids = torch.randint(0, model["vocab_size"], (batch, t["seq_len"] + 1), generator=g)
    return model, params, {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def whole_batch(params, model, batch, with_terms: bool):
    """Autograd of the whole batch's objective in one piece: the mean token
    cross-entropy plus, with ``with_terms``, the toy term of every row."""
    leaves = {k: v.detach().float().requires_grad_(True) for k, v in params.items()}
    prec = Precision("float32")
    h, _, terms = lm.forward(leaves, model, batch["tokens"], prec)
    lg = lm.logits(leaves, model, h, prec)
    loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), batch["labels"].reshape(-1).long())
    if with_terms:
        loss = loss + WEIGHT * torch.stack(terms["square"]).sum() / batch["tokens"].shape[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), float(loss.detach())


@pytest.mark.parametrize("rows", [1, 3], ids=["rows_1", "rows_all"])
def test_a_familys_loss_terms_reach_the_gradients_and_add_up_over_row_blocks(rows, monkeypatch):
    model, params, batch = setup("smollm-135m.train")
    monkeypatch.setitem(sys.modules, "bench.reference.toy", toy_family())
    model = dict(model, family="toy")
    grads, loss = _loss_and_grads(params, model, batch, Precision("float32"), rows)
    want, want_loss = whole_batch(params, model, batch, with_terms=True)
    ce_only, ce_loss = whole_batch(params, model, batch, with_terms=False)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert abs(loss - ce_loss) > 1e-3  # the term is no rounding
    moved = 0
    for k, g in grads.items():
        scale = float(want[k].norm()) + 1e-12
        assert float((g - want[k]).norm()) <= 1e-4 * scale, k
        moved += float((want[k] - ce_only[k]).norm()) > 1e-2 * scale
    assert moved  # the term reaches the gradients


def parent_loss_and_grads(params, model, batch, prec, rows):
    """The objective before families could add terms: each block of rows'
    token cross-entropy sum over the batch's token count."""
    leaves = {k: v.detach().to(torch.float32, copy=True).requires_grad_(True)
              for k, v in params.items()}
    tokens, labels = batch["tokens"], batch["labels"]
    count = labels.numel()
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for r in range(0, tokens.shape[0], rows):
        h, _, _ = lm.forward(leaves, model, tokens[r:r + rows], prec)
        lg = lm.logits(leaves, model, h, prec)
        loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                               labels[r:r + rows].reshape(-1).long(), reduction="sum") / count
        for g, d in zip(grads.values(), torch.autograd.grad(loss, list(leaves.values()))):
            g.add_(d)
        total += float(loss.detach())
    return grads, total


@pytest.mark.parametrize("name", ["smollm-135m.train", "mamba2-130m.train"],
                         ids=["dense", "ssm"])
def test_a_family_without_terms_trains_on_the_cross_entropy_to_the_bit(name):
    model, params, batch = setup(name, batch=4)
    prec = Precision("float32")
    grads, loss = _loss_and_grads(params, model, batch, prec, 2)
    want, want_loss = parent_loss_and_grads(params, model, batch, prec, 2)
    assert loss == want_loss
    assert all(torch.equal(grads[k], want[k]) for k in want)
