"""Training cells (traffic ``kind: train``): one client steps the program's
training step back to back on fresh batches.

Set-up builds the one training object (weights from the seed, the AdamW
state, the step) and drives it through its first ``check_steps`` steps on
the window's own feed; those steps warm up every shape, and their readings
are what the reference is held to.  The window continues the same object.
Losses stay on the device until the window closes on a synchronize.

A driver of a traffic kind (``bench/harness/<kind>.py``, found by the
traffic file's ``kind``) gives ``setup``, ``window``, ``check`` and, for the
calibration, ``readings``, ``reference``, ``as_served``, ``numbers``,
``faults`` and ``details``; ``FLOPS`` and ``BACKWARD`` tell the readers
what a call computes.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from bench.harness import compare, program
from bench.harness.trace import sync, ticks
from bench.harness.weights import flatten, make_weights
from bench.reference import adamw, lm
from bench.reference.precision import Precision
from bench.work.model import train_flops

FLOPS = train_flops  # model FLOPs of one call (bench/work/model.py)
BACKWARD = True      # a call runs the backward (and any recompute)


def batch_seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 + k) % 2 ** 63


def feed(run, k: int) -> Dict[str, torch.Tensor]:
    """Batch k of the run: B rows of S + 1 uniform token ids, the labels the
    next token."""
    t, m = run.traffic, run.model
    g = torch.Generator(device=run.device).manual_seed(batch_seed(run.seed, k))
    ids = torch.randint(0, m["vocab_size"], (t["batch"], t["seq_len"] + 1), generator=g,
                        device=run.device, dtype=torch.int32)
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}


def setup(run) -> dict:
    model, opt = run.model, run.traffic["optimizer"]
    cfg = program.model_config(model)
    flat = make_weights(model, run.seed, run.device)
    program.check_layout(cfg, flat)
    p0 = {k: t.clone() for k, t in flat.items()}
    params = program.params_tree(flat, train=True)
    state = program.init_opt_state(params, opt)
    step = program.train_step(cfg, opt)
    losses = []
    for k in range(1, run.traffic["check_steps"] + 1):
        params, state, metrics = step(params, state, feed(run, k))
        losses.append(metrics["loss"])
        if k == 1:  # the first gradient as the optimizer took it: m = (1 - b1) g
            grads = {n: t / (1 - opt["b1"]) for n, t in flatten(state["m"]).items()}
            grad_norms = compare.leaf_norms(grads, model)
            del grads
    cur = flatten(params)
    with torch.no_grad():
        change = compare.leaf_norms({n: cur[n].float() - p0[n].float() for n in p0}, model)
    del p0, cur
    readings = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
                "change_norms": change}
    return {"step": step, "params": params, "state": state, "k": len(losses) + 1,
            "readings": readings}


def window(run, prog: dict, seconds: Optional[float] = None,
           calls: Optional[int] = None) -> dict:
    """Steps back to back for ``seconds`` (or ``calls`` steps), continuing
    the training object; closed on a synchronize."""
    step, params, state, k = prog["step"], prog["params"], prog["state"], prog["k"]
    losses, marks = [], []
    B, S = run.traffic["batch"], run.traffic["seq_len"]
    t0 = time.perf_counter()
    for now in ticks(t0, seconds, calls):
        marks.append(now)
        with run.tracer.span("feed"):
            batch = feed(run, k)
        with run.tracer.span("train_step"):
            params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"])
        k += 1
    sync(run.device)
    seconds = time.perf_counter() - t0
    prog.update(params=params, state=state, k=k)
    finite = torch.isfinite(torch.stack(losses)).tolist() if losses else []
    marks.append(t0 + seconds)
    return {"calls": len(losses), "seconds": seconds, "tokens": len(losses) * B * S,
            "failed": finite.count(False), "call_s": [b - a for a, b in zip(marks, marks[1:])]}


def readings(prog: dict) -> dict:
    """What the check compares: the readings of the first steps."""
    return prog["readings"]


def reference(run, got: Optional[dict], prec: Precision) -> dict:
    return reference_readings(run, prec)


def as_served(ref: dict) -> dict:
    """The reference's readings put in the program's place (the control)."""
    return ref


def check(run, prog: dict, prec: Precision) -> Dict[str, float]:
    """The numbers compared: the program's first steps against the
    reference's in ``prec``."""
    return numbers(run, readings(prog), reference_readings(run, prec))


def faults(run, got: Optional[dict], prec: Precision) -> Dict[str, dict]:
    """Readings of the faults a calibration reads, planted in the reference:
    half of each batch left out, the mean taken over the rest."""
    return {"half_batch": reference_readings(run, prec, rows=run.traffic["batch"] // 2)}


def details(run, got: dict, ref: dict) -> dict:
    """The three worst leaves of each number and every step's losses."""
    out = {}
    moved = compare.moved_leaves(ref["grad_norms"])
    for key, counted in (("grad_norms", None), ("change_norms", moved)):
        gaps = compare.norm_gaps(got[key], ref[key], counted)
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    out["losses"] = [got["losses"], ref["losses"]]
    return out


def reference_readings(run, prec: Precision, rows: Optional[int] = None) -> dict:
    """The reference's readings of the same first steps: the same weights
    and batches, float32 products (or the control's), rows in blocks.
    ``rows`` keeps only the first rows of each batch (a planted fault)."""
    model, opt, t = run.model, run.traffic["optimizer"], run.traffic
    params = make_weights(model, run.seed, run.device)
    p0 = {k: v.clone() for k, v in params.items()}
    state: Dict[str, Dict[str, torch.Tensor]] = {"m": {}, "v": {}}
    losses = []
    for k in range(1, t["check_steps"] + 1):
        batch = {n: v[:rows] for n, v in feed(run, k).items()}
        grads, loss = _loss_and_grads(params, model, batch, prec, t["reference_rows"])
        losses.append(loss)
        if k == 1:
            grad_norms = compare.leaf_norms(adamw.clipped(grads, opt["clip_norm"]), model)
        adamw.update(params, grads, state, k, opt)
        del grads
    change = compare.leaf_norms({n: params[n].float() - p0[n].float() for n in p0}, model)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def _loss_and_grads(params, model, batch, prec, rows):
    """(float32 gradients, loss) of the batch's training loss
    (``lm.train_loss``), its rows taken ``rows`` at a time."""
    leaves = {k: v.detach().to(torch.float32, copy=True).requires_grad_(True)
              for k, v in params.items()}
    tokens, labels = batch["tokens"], batch["labels"]
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for r in range(0, tokens.shape[0], rows):
        loss = lm.train_loss(leaves, model, tokens[r:r + rows], labels[r:r + rows], prec,
                             tuple(labels.shape))
        for g, d in zip(grads.values(), torch.autograd.grad(loss, list(leaves.values()))):
            g.add_(d)
        total += float(loss.detach())
    return grads, total


def numbers(run, got: dict, ref: dict) -> Dict[str, float]:
    """Each step's loss, the first gradient and the change over the check
    steps, by the worst leaf; the first gradient by the median leaf too."""
    return {
        "loss_gap": max(abs(a - b) if math.isfinite(a) else math.inf
                        for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": compare.worst_norm_gap(got["grad_norms"], ref["grad_norms"]),
        "grad_gap_median": compare.median_norm_gap(got["grad_norms"], ref["grad_norms"]),
        "change_gap": compare.worst_norm_gap(got["change_norms"], ref["change_norms"],
                                             compare.moved_leaves(ref["grad_norms"])),
    }
