"""Run the port's full dry-run sweep: every (arch × shape × mesh) cell as a
subprocess of ``python -m repro_torch.launch.dryrun`` (twin of
``scripts/run_dryrun_sweep.py``).

Cells are ordered cheapest-first (decode < prefill < train; small archs
first) so failures surface early.  Results are cached as JSON files;
re-running skips done cells.  Each cell traces its step on meta tensors
over a ``fake`` process group of 256 or 512 ranks on the CPU.

    PYTHONPATH=src python scripts/run_dryrun_sweep_torch.py [outdir]
"""

import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH_ORDER = [
    "smollm-135m", "mamba2-130m", "musicgen-large", "internvl2-2b",
    "starcoder2-7b", "llama3-8b", "qwen3-14b", "deepseek-moe-16b",
    "jamba-v0.1-52b", "qwen3-moe-235b-a22b",
]
SHAPE_ORDER = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]
CELL_SECONDS = 3000


def main():
    outdir = Path(sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun_torch")
    outdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    jobs = [(arch, shape, mp) for mp in (False, True) for shape in SHAPE_ORDER
            for arch in ARCH_ORDER]
    t0 = time.time()
    for i, (arch, shape, mp) in enumerate(jobs):
        mesh = "2x16x16" if mp else "16x16"
        tag = f"{arch}__{shape}__{mesh}"
        if (outdir / f"{tag}.json").exists():
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", str(outdir)]
        if mp:
            cmd.append("--multi-pod")
        print(f"[{i + 1}/{len(jobs)}] {tag}  (t={time.time() - t0:.0f}s)", flush=True)
        try:
            subprocess.run(cmd, timeout=CELL_SECONDS, check=False, env=env)
        except subprocess.TimeoutExpired:
            (outdir / f"{tag}.json").write_text(
                '{"arch": "%s", "shape": "%s", "mesh": "%s", '
                '"status": "error", "error": "trace timeout %ds"}'
                % (arch, shape, mesh, CELL_SECONDS)
            )
    print(f"sweep done in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
