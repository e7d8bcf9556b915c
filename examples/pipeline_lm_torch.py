"""Pipeline-parallel LM forward on the PyTorch port: the partitioner's
chain-DP stage plan executed with the GPipe pipeline over a ``stage`` mesh
axis.  Twin of ``examples/pipeline_lm.py``.

A reduced smollm runs its 8 transformer blocks as 4 pipeline stages (stage
assignment from ``explore_lm``'s optimal contiguous split, printed; the
blocks are executed 2 a stage, as the reference's example does).  The
pipelined forward, through the kernels on the card, is held to the
sequential forward in plain PyTorch (``use_kernels="off"``); one gradient
through the pipeline (``autograd.grad`` of the outputs' mean square with
respect to the inputs, every backward hop) is held to the sequential
gradient through the same kernels, and its distance from the plain
sequential gradient is printed.

    PYTHONPATH=src python examples/pipeline_lm_torch.py [--device cpu]

The script starts 4 rank processes of itself over a gloo group (a
``FileStore`` in a temporary directory, the ranks joined within
``JOIN_SECONDS``; a rank that fails fails the run with every rank's log).
Each rank computes its stage on ``--device``: ``cuda:0`` by default, so all
four share one card, and the hops between them go through host memory
(``distributed/pipeline.py``: gloo carries no CUDA point-to-point, and NCCL
refuses two ranks on one card).  These are host-staged hops on one card,
not a multi-card pipeline.  Without CUDA it raises, unless ``--device cpu``
is passed.  Each rank prints its kernels' launch counts on a line of its
own (``launches rank=...``): one pipelined forward, and the gradient pass.
"""

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.partitioner import explore_lm
from repro_torch.distributed.pipeline import gpipe_apply, pipeline_bubble_fraction
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.rmsnorm import kernel as rms
from repro_torch.model import lm
from repro_torch.model.blocks import block_fwd
from repro_torch.model.layers import resolve_device, torch_dtype
from repro_torch.pytree import tree_map

N_STAGES, N_MICRO, B, S = 4, 4, 8, 64
TOL = 1e-2  # the reference example's
REPS = 5  # timed pipelined and sequential forwards, after one untimed
JOIN_SECONDS = 600
COLLECTIVE_SECONDS = 300


def launch_counts() -> dict:
    return {"flash_fwd": flash.FWD_LAUNCHES, "flash_bwd_dq": flash.DQ_LAUNCHES,
            "flash_bwd_dkv": flash.DKV_LAUNCHES, "rmsnorm": rms.LAUNCHES}


def zero_launch_counts() -> None:
    flash.FWD_LAUNCHES = flash.DQ_LAUNCHES = flash.DKV_LAUNCHES = rms.LAUNCHES = 0


def config():
    return dataclasses.replace(get_config("smollm-135m").reduced(), num_layers=8)


def stage_plan(cfg):
    """The chain-DP stage of each actor (embed..blocks..head)."""
    plans = explore_lm(cfg, seq_len=S, global_batch=B, total_chips=N_STAGES,
                       stage_options=(N_STAGES,))
    return plans[0].stage_of_layer


def inputs(cfg, params, device):
    """The seeded token batch's embeddings, in the activation type."""
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        x = F.embedding(tokens.to(device), params["embed"]["tok"])
    return x.to(torch_dtype(cfg.dtype))


def rank_run(rank: int, device: torch.device) -> dict:
    """This rank's stage of the pipeline; rank 0 also runs the sequential
    forward (in plain PyTorch) and gradient (through the kernels, and in
    plain PyTorch) and holds the pipeline to them."""
    from torch.distributed.device_mesh import init_device_mesh

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    mesh = init_device_mesh("cpu", (N_STAGES,), mesh_dim_names=("stage",))
    cfg = config()
    plain = dataclasses.replace(cfg, use_kernels="off")
    params = lm.init_model(cfg, 0, device=device)
    stage_map = stage_plan(cfg)
    if rank == 0:
        print(f"chain-DP stage map (embed..blocks..head): {stage_map}", flush=True)

    x = inputs(cfg, params, device)
    positions = torch.arange(S, dtype=torch.int32, device=device)
    kind = cfg.block_kind(0)
    per = cfg.num_layers // N_STAGES  # contiguous blocks a stage
    layer_p = params["layers"]["pos0"]  # leaves (num_layers, ...)
    stage_params = tree_map(lambda a: a.reshape(N_STAGES, per, *a.shape[1:]), layer_p)

    def stage_fn(pstage, xin):
        for j in range(per):
            xin, _, _ = block_fwd(tree_map(lambda a: a[j], pstage), xin, kind, cfg, positions)
        return xin

    def pipelined(xin):
        xm = xin.reshape(N_MICRO, B // N_MICRO, S, cfg.d_model)
        return gpipe_apply(stage_fn, stage_params, xm, mesh=mesh, axis="stage").reshape(
            B, S, cfg.d_model)

    def sequential(xin, c=cfg):
        for i in range(c.num_layers):
            xin, _, _ = block_fwd(tree_map(lambda a: a[i], layer_p), xin, kind, c, positions)
        return xin

    def seq_grad(c):
        xs = x.detach().requires_grad_(True)
        return torch.autograd.grad(sequential(xs, c).float().square().mean(), xs)[0].float()

    def timed(fn) -> list:
        ms = []
        with torch.no_grad():
            for _ in range(REPS):
                sync()
                t0 = time.perf_counter()
                fn(x)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    zero_launch_counts()
    with torch.no_grad():
        y_pipe = pipelined(x)
    sync()
    fwd_launches = launch_counts()
    pipe_ms = timed(pipelined)

    xg = x.detach().requires_grad_(True)
    zero_launch_counts()
    (g_pipe,) = torch.autograd.grad(pipelined(xg).float().square().mean(), xg)
    sync()
    grad_launches = launch_counts()
    print(f"launches rank={rank} forward={json.dumps(fwd_launches)} "
          f"grad={json.dumps(grad_launches)}", flush=True)
    res = {"rank": rank, "launches": {"forward": fwd_launches, "grad": grad_launches}}

    dist.barrier()  # the sequential runs have the device to themselves
    if rank == 0:
        with torch.no_grad():
            y_ref = sequential(x, plain)
        seq_ms = timed(sequential)
        g_ref, g_plain = seq_grad(cfg), seq_grad(plain)
        err = float(torch.max(torch.abs(y_pipe.float() - y_ref.float())))

        def rel_err(g):
            return float(torch.max(torch.abs(g_pipe.float() - g)) / torch.max(torch.abs(g)))

        grad_err, grad_err_plain = rel_err(g_ref), rel_err(g_plain)
        print(f"pipelined forward vs sequential: max_err={err:.2e}", flush=True)
        assert err < TOL, "pipeline does not match sequential execution"
        print(f"gradient through the pipeline vs sequential: rel_err={grad_err:.2e}",
              flush=True)
        assert grad_err < TOL, "pipeline gradient does not match the sequential one"
        print(f"gradient through the pipeline vs plain sequential: rel_err={grad_err_plain:.2e}",
              flush=True)
        bubble = pipeline_bubble_fraction(N_MICRO, N_STAGES)
        print(f"stages={N_STAGES} microbatches={N_MICRO} bubble={bubble:.0%} -> MATCH",
              flush=True)
        pipe_med, seq_med = float(np.median(pipe_ms)), float(np.median(seq_ms))
        hops = "host-staged hops" if device.type == "cuda" else "gloo hops"
        print(f"forward on {device}: pipelined {pipe_med:.3f} ms ({hops}) "
              f"against sequential {seq_med:.3f} ms, median of {REPS}", flush=True)
        res.update(stage_map=stage_map, max_err=err, grad_err=grad_err,
                   grad_err_plain=grad_err_plain, bubble=bubble,
                   pipe_ms=pipe_ms, seq_ms=seq_ms, pipe_ms_median=pipe_med,
                   seq_ms_median=seq_med, output=y_pipe.float().cpu().numpy().tolist())
    dist.barrier()
    return res


def rank_main(rank: int, work: Path, device: str) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store"), N_STAGES), rank=rank,
        world_size=N_STAGES, timeout=datetime.timedelta(seconds=COLLECTIVE_SECONDS))
    try:
        res = rank_run(rank, dev)
        (work / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def spawn(device: torch.device, work: Path) -> list:
    """Run the 4 ranks; returns their logs, or raises with every log."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r),
         "--work", str(work), "--device", str(device)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(N_STAGES)]
    logs = []
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                logs.append(f"(rank not joined within {JOIN_SECONDS} s)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if [p.returncode for p in procs] != [0] * N_STAGES:
        raise RuntimeError("pipeline_lm: a rank failed\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return logs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' for the CPU")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.rank, Path(args.work), args.device)
    device = resolve_device(args.device, "pipeline_lm")
    if device.type == "cuda":  # build once here, not in each rank
        flash.LIBRARY.build()
        rms.LIBRARY.build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pipeline_lm_") as tmp:
        logs = spawn(device, Path(tmp))
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(N_STAGES)]
    for log in logs:
        print(log, end="")
    out = dict(ranks[0])
    out["output"] = np.asarray(out["output"], np.float32)
    out["launches"] = {r["rank"]: r["launches"] for r in ranks}
    out["seconds"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    main()
