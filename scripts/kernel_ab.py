"""Time the port's kernels from two source trees in turns, on one card.

    python3 scripts/kernel_ab.py PARENT/src CHANGE/src CHANGE/src PARENT/src

Each argument is a ``src`` directory holding a ``repro_torch`` package (a
``git archive`` of another commit unpacked under a git-ignored directory, or
this checkout's ``src``).  Every argument runs in a process of its own, in
the order given, which builds that tree's kernels from its own sources and
times, by CUDA-graph replay with ``chip_smoke.py``'s helpers and inputs:

* the bf16 SSD scan at the serving path's shape (B=8, S=2048, nh=24, P=64,
  N=128, chunk 256), ms per call;
* the stream kernel on the four fused Table-I programs at N = 4*4096 and
  32*4*4096, ms per launch on the device, and at N = 4*4096 the host's ms
  per call back to back (``chip_smoke.call_ms``: the wrapper's own cost).

Prints one JSON line per run with the tree, the card's name and power limit
(``nvidia-smi``) and the times; exits non-zero when CUDA is missing or a run
fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import chip_smoke as cs
from repro_torch.apps.streams import NETWORKS
from repro_torch.kernels.ssd_scan import kernel as ssd
from repro_torch.kernels.stream_fused import kernel as stream

B, S, nh, P, N, chunk, dtype = cs.SSD_SHAPES["path"]
x, dt, A, B_, C_ = cs.ssd_inputs(B, S, nh, P, N, dtype, 200)
xf = x.transpose(1, 2).reshape(B * nh, S, P).contiguous()
dtf = dt.transpose(1, 2).reshape(B * nh, S).contiguous()
daf = dtf * A.repeat(B)[:, None]

def scan():
    return ssd.ssd_scan_cuda(xf, dtf, daf, B_, C_, nheads=nh, chunk=chunk)

out = {"tree": sys.argv[1], "ssd_path_ms": cs.device_ms(scan, 50), "stream_ms": {},
       "stream_call_ms": {}}
for name, prog in cs.network_programs(NETWORKS).items():
    for size in ("main", "serve"):
        xs = cs.seeded_inputs(prog, cs.TOKENS[size], 0)

        def launch():
            return stream.fused_stream_cuda(xs, prog)

        out["stream_ms"][f"{name}@{cs.TOKENS[size]}"] = cs.device_ms(
            launch, 200 if size == "main" else 40)
        if size == "main":
            out["stream_call_ms"][name] = cs.call_ms(launch, 200)
print(json.dumps(out), flush=True)
"""


def main(trees) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    rc = 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(Path(tree).resolve()), str(ROOT)],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            rc = 1
            continue
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"card": smi, **row}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
