"""Perf iteration script for the port: trace ONE cell with config/rule
overrides through ``python -m repro_torch.launch.dryrun`` and print the three
roofline terms next to the baseline artifact (twin of
``scripts/perf_cell.py``).

  PYTHONPATH=src python scripts/perf_cell_torch.py qwen3-moe-235b-a22b train_4k \\
      --set batch_chunks=8 --set remat=block [--rule seq=None] [--tag exp1]

The terms divide the per-device counts by one NVIDIA H100's datasheet peaks
(SXM part, dense, at its 700 W power limit; a card set below it is slower):
bf16 tensor cores, HBM3, NVLink 4 (the mesh's ICI axes, one direction) and
one 400 Gb/s InfiniBand NDR port per GPU (the ``pod`` axis, DCN).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CARD = "NVIDIA H100 SXM 80GB HBM3, 700 W (datasheet peaks)"
PEAK = 989e12  # bf16 dense tensor-core FLOP/s
HBM = 3.35e12  # bytes/s
ICI = 450e9  # NVLink 4: 900 GB/s a GPU, both directions together
DCN_PER_CHIP = 50e9  # one 400 Gb/s NDR port per GPU
SRC = Path(__file__).resolve().parents[1] / "src"


def terms(a):
    return {
        "compute_s": a["flops"] / PEAK,
        "memory_s": a.get("bytes_fused", a["bytes"]) / HBM,
        "memory_hi_s": a["bytes"] / HBM,
        "collective_s": a["ici_bytes"] / ICI + a["dcn_bytes"] / DCN_PER_CHIP,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--set", action="append", default=[], dest="sets")
    ap.add_argument("--rule", action="append", default=[], dest="rules")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default="exp")
    ap.add_argument("--baseline-dir", default="artifacts/dryrun_torch")
    args = ap.parse_args()

    mesh = "2x16x16" if args.multi_pod else "16x16"
    name = f"{args.arch}__{args.shape}__{mesh}.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="perf_cell_") as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", args.arch,
               "--shape", args.shape, "--out", tmp]
        cmd += ["--multi-pod"] if args.multi_pod else []
        for s in args.sets:
            cmd += ["--set", s]
        for r in args.rules:
            cmd += ["--rule", r]
        subprocess.run(cmd, check=False, env=env)
        out = Path("artifacts/perf")
        out.mkdir(parents=True, exist_ok=True)
        dest = out / f"{args.arch}__{args.shape}__{args.tag}.json"
        shutil.copy(Path(tmp) / name, dest)
    res = json.loads(dest.read_text())
    if res["status"] != "ok":
        print(json.dumps(res, indent=1)[:3000])
        return

    base_p = Path(args.baseline_dir) / name
    base = json.loads(base_p.read_text()) if base_p.exists() else None
    t_new = terms(res["analyzed"])
    print(f"== {args.arch}/{args.shape} ({mesh})  overrides={args.sets} {args.rules}")
    print(f"   roofline against {CARD}")
    print(f"{'term':14s} {'baseline':>12s} {'experiment':>12s} {'delta':>8s}")
    t_base = terms(base["analyzed"]) if base and base["status"] == "ok" else None
    for k in t_new:
        b = t_base[k] if t_base else float("nan")
        d = (t_new[k] / b - 1) * 100 if t_base and b else float("nan")
        print(f"{k:14s} {b:12.4f} {t_new[k]:12.4f} {d:+7.1f}%")
    mem = res["memory_analysis"]["temp_size_in_bytes"] / 2**30
    memb = base["memory_analysis"]["temp_size_in_bytes"] / 2**30 if t_base else float("nan")
    print(f"{'temp_GiB':14s} {memb:12.2f} {mem:12.2f}")
    print(f"{'trace_s':14s} {'':>12s} {res['t_trace_s']:12.2f}")


if __name__ == "__main__":
    main()
