"""Prefill cells (traffic ``kind: prefill``): one client in a closed loop
sends a batch of prompts through the program's prefill step, reads back its
first tokens (the argmax of the last-token logits) and sends the next.

A request's time to first token runs from its submission to the first
tokens on the host.  Every request's served tokens are kept; the logits and
the whole cache of ``keep_requests`` requests drawn from the seed among the
first ``keep_among`` are kept too.  After the window a sample of
``sample_requests`` finished requests, drawn from the seed, is held to the
reference: the served tokens against its logits, and the kept logits and
caches against its own.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Optional

import torch

from bench.harness import compare, program
from bench.harness.trace import ticks
from bench.harness.train import batch_seed
from bench.harness.weights import flatten, make_weights
from bench.reference import lm
from bench.reference.precision import Precision
from bench.work.model import prefill_flops

FLOPS = prefill_flops  # model FLOPs of one call (bench/work/model.py)
BACKWARD = False       # a call runs the forward only


def prompts(run, i: int) -> torch.Tensor:
    """Request i's (B, S) prompts: uniform token ids from the seed."""
    t = run.traffic
    g = torch.Generator(device=run.device).manual_seed(batch_seed(run.seed, i))
    return torch.randint(0, run.model["vocab_size"], (t["batch"], t["prompt_len"]),
                         generator=g, device=run.device, dtype=torch.int32)


def kept_requests(run) -> set:
    t = run.traffic
    return set(random.Random(run.seed).sample(range(t["keep_among"]), t["keep_requests"]))


def setup(run) -> dict:
    cfg = program.model_config(run.model)
    flat = make_weights(run.model, run.seed, run.device)
    program.check_layout(cfg, flat)
    params = program.params_tree(flat, train=False)
    step = program.prefill_step(cfg)
    for i in range(1, run.traffic["warmup_requests"] + 1):  # negative ids: not served
        logits, cache = step(params, {"tokens": prompts(run, -i)})
        logits.argmax(-1).cpu()
        del logits, cache
    return {"step": step, "params": params}


def window(run, prog: dict, seconds: Optional[float] = None,
           calls: Optional[int] = None) -> dict:
    """Request batches one after another for ``seconds`` (or ``calls`` of
    them), numbered on from the requests served before."""
    step, params = prog["step"], prog["params"]
    served, kept = prog.setdefault("served", []), prog.setdefault("kept", {})
    keep = kept_requests(run)
    ttft = []
    B, S = run.traffic["batch"], run.traffic["prompt_len"]
    t0 = time.perf_counter()
    for _ in ticks(t0, seconds, calls):
        i = len(served)
        with run.tracer.span("feed"):
            tokens = prompts(run, i)
        t_sub = time.perf_counter()
        with run.tracer.span("prefill"):
            logits, cache = step(params, {"tokens": tokens})
        with run.tracer.span("read_back"):
            first = logits.argmax(-1).cpu()
        ttft.append(time.perf_counter() - t_sub)
        served.append(first)
        if i in keep:
            kept[i] = (logits, cache)
        del logits, cache
    seconds = time.perf_counter() - t0
    V = run.model["vocab_size"]
    failed = sum(int(((f < 0) | (f >= V)).any()) for f in served[len(served) - len(ttft):])
    return {"calls": len(ttft), "seconds": seconds, "tokens": len(ttft) * B * S,
            "ttft_s": ttft, "failed": failed, "call_s": ttft}


def readings(prog: dict) -> dict:
    """What the window produced: served tokens of every request, the kept
    requests' logits and caches (flat, one entry per cache leaf)."""
    return {"served": prog["served"],
            "kept": {i: (lg, flatten(c)) for i, (lg, c) in prog["kept"].items()}}


def reference(run, got: Optional[dict], prec: Precision) -> Dict[int, tuple]:
    """The reference's outputs for the sample of the requests ``got``
    finished (of the first ``keep_among`` where nothing was served)."""
    n_done = len(got["served"]) if got is not None else run.traffic["keep_among"]
    return reference_outputs(run, sample(run, n_done), prec)


def check(run, prog: dict, prec: Precision) -> Dict[str, float]:
    """The numbers compared: the served sample and the kept requests
    against the reference's outputs in ``prec``."""
    got = readings(prog)
    return numbers(run, got, reference(run, got, prec))


def faults(run, got: Optional[dict], prec: Precision) -> Dict[str, dict]:
    """No fault is planted in a calibration of a prefill cell: a half batch
    and an altered token are the CPU tests' (``bench/tests/test_bench_run.py``)."""
    return {}


def details(run, got: dict, ref: dict) -> dict:
    return {}


def reference_outputs(run, requests, prec: Precision) -> Dict[int, tuple]:
    """{request: (last-token logits, caches or None)}: caches for the kept
    requests only.  float32 products (or the control's), rows in blocks."""
    params = {k: v.float() for k, v in make_weights(run.model, run.seed, run.device).items()}
    keep = kept_requests(run)
    rows = run.traffic["reference_rows"]
    out = {}
    with torch.no_grad():
        for i in requests:
            tokens = prompts(run, i)
            parts = [lm.prefill(params, run.model, tokens[r:r + rows], prec)
                     for r in range(0, tokens.shape[0], rows)]
            logits = torch.cat([p[0] for p in parts])
            caches = None
            if i in keep:
                caches = {k: torch.cat([p[1][k] for p in parts], dim=1) for k in parts[0][1]}
            out[i] = (logits, caches)
            del parts
    return out


def as_served(outputs: Dict[int, tuple]) -> dict:
    """Reference outputs in the form of a run's readings: the reference put
    in the program's place (the control) serves its argmax, and its kept
    caches go under the program's leaf paths."""
    return {"served": {i: lg.argmax(-1) for i, (lg, _) in outputs.items()},
            "kept": {i: (lg, {f"pos0/{k}": v for k, v in c.items()})
                     for i, (lg, c) in outputs.items() if c is not None}}


def sample(run, n_done: int) -> list:
    """The finished requests the reference checks, drawn from the seed, with
    the kept ones among them (every request has the same length)."""
    k = min(n_done, run.traffic["sample_requests"])
    drawn = set(random.Random(run.seed + 1).sample(range(n_done), k))
    return sorted(drawn | {i for i in kept_requests(run) if i < n_done})


def numbers(run, got: dict, ref: Dict[int, tuple]) -> Dict[str, float]:
    """``token_gap``: the widest gap by which a served token's logit lies
    below the reference's best; ``logits_err`` and ``cache_err``: the
    largest relative error of a kept request's logits (true vocabulary) and
    of any layer of any cache leaf."""
    V = run.model["vocab_size"]
    gap = 0.0
    for i, (ref_logits, _) in ref.items():
        lg = ref_logits[:, :V]
        tok = got["served"][i].to(lg.device).long()
        if ((tok < 0) | (tok >= V)).any():
            return {"token_gap": float("inf"), "logits_err": float("inf"),
                    "cache_err": float("inf")}
        gap = max(gap, float((lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]).max()))
    logits_err = cache_err = 0.0
    for i, (lg, cache) in got["kept"].items():
        ref_logits, ref_cache = ref[i]
        logits_err = max(logits_err, max(compare.rel_err(lg[r, :V], ref_logits[r, :V])
                                         for r in range(lg.shape[0])))
        for path, t in cache.items():
            r = ref_cache[path.rsplit("/", 1)[-1]]  # "pos0/k" -> "k"
            cache_err = max(cache_err, max(compare.rel_err(t[layer], r[layer])
                                           for layer in range(t.shape[0])))
    return {"token_gap": gap, "logits_err": logits_err, "cache_err": cache_err}
