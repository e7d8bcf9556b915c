"""End-to-end training driver (port of ``repro/launch/train.py``, one card).

Wires together: config -> data-pipeline actors (host threads) -> the train
step on the card (``launch/steps.py``; attention through the CUDA flash
kernels unless ``cfg.use_kernels == "off"``) -> async checkpointing ->
fault-tolerant supervisor.  It runs without a mesh: the reference's
``make_test_mesh`` needs no process group, the port's does (``launch/
mesh.py``).  A sharded step is ``launch/steps.py``'s under ``shard_ctx`` with
the parameters placed (``distributed/sharding.py``).

``device=None`` means ``cuda:0`` and raises when CUDA is not available;
``device="cpu"`` runs everything on the CPU with the kernels' plain versions
(the tests do).

Usage (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --steps 100
Options: --full (the exact published widths), --fail-at N (chaos drill: inject
a SimulatedFailure at step N and recover), --device cpu, --ckpt-dir to resume.
"""

from __future__ import annotations

import argparse
import math
import tempfile
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.distributed.fault import SimulatedFailure, TrainSupervisor
from repro_torch.launch.steps import make_train_step
from repro_torch.model import lm
from repro_torch.model.layers import resolve_device
from repro_torch.optim import OptConfig, init_opt_state


def run_training(
    arch: str = "smollm-135m",
    *,
    steps: int = 50,
    global_batch: int = 8,
    seq_len: int = 128,
    reduced: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    fail_at: Optional[int] = None,
    accum_steps: int = 1,
    lr: float = 1e-3,
    log_every: int = 10,
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
    quiet: bool = False,
) -> Dict[str, Any]:
    dev = resolve_device(device, "run_training")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    opt = OptConfig(lr=lr, warmup_steps=max(2, steps // 20), total_steps=steps)

    data = DataPipeline(
        DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len,
            global_batch=global_batch,
            seed=seed,
            embed_dim=cfg.d_model if cfg.frontend != "none" else 0,
        )
    ).start()

    train_step = make_train_step(cfg, opt, accum_steps)

    def make_state():
        params = lm.init_model(cfg, seed, device=dev)
        return {"params": params, "opt": init_opt_state(params, opt)}

    losses, step_seconds = [], []
    failed = []

    def step_fn(state, i):
        if fail_at is not None and i == fail_at and not failed:
            failed.append(i)
            raise SimulatedFailure(f"injected failure at step {i}")
        t0 = time.perf_counter()
        batch = data.get_batch()
        params, opt_state, metrics = train_step(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])  # waits for the step to finish on the card
        step_seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if not quiet and (i % log_every == 0 or i == steps - 1):
            print(
                f"step {i:5d} loss {loss:8.4f} ce {float(metrics['ce']):8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"lr {float(metrics['lr']):.2e} {step_seconds[-1]:.3f}s",
                flush=True,
            )
        return {"params": params, "opt": opt_state}, metrics

    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    sup = TrainSupervisor(step_fn, make_state, ckpt_dir, ckpt_every=ckpt_every)
    try:
        report = sup.run(steps)
    finally:
        data.stop()
        sup.ckpt.close()
    first = float(np.mean(losses[: max(3, len(losses) // 10)]))
    last = float(np.mean(losses[-max(3, len(losses) // 10):]))
    return {
        "arch": arch,
        "device": str(dev),
        "steps": report.steps_done,
        "restarts": report.restarts,
        "loss_first": first,
        "loss_last": last,
        "improved": last < first,
        "finite": all(math.isfinite(x) for x in losses),
        "losses": losses,
        "step_seconds": step_seconds,
        "tokens_per_step": global_batch * seq_len,
        "ckpt_dir": ckpt_dir,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' for the CPU")
    args = ap.parse_args()
    out = run_training(
        args.arch, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        reduced=not args.full, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at=args.fail_at,
        accum_steps=args.accum, lr=args.lr, device=args.device,
    )
    print(
        f"done: steps={out['steps']} restarts={out['restarts']} "
        f"loss {out['loss_first']:.4f} -> {out['loss_last']:.4f} "
        f"improved={out['improved']}"
    )


if __name__ == "__main__":
    main()
