"""Count how often PLink launches each Table-I network's device partition, over
repeated runs of the same placement, from one or more source trees.

    python3 scripts/plink_launches.py [--runs R] [--device cuda:0] SRC [SRC ...]

Each ``SRC`` is a ``src`` directory holding a ``repro_torch`` package (a
``git archive`` of another commit unpacked under a git-ignored directory, or
this checkout's ``src``).  Every argument runs in a process of its own, in the
order given.  For each network at ``chip_smoke.py``'s phase-3 size and block
(``backend="device"``, the default megastep), the process compiles and runs
the network ``R`` times on a quiet host, then ``R`` times while one busy
process per CPU core competes with the runtime's threads, and records each
run's ``RunReport.plink_launches`` and the stream kernel's launches (on a
CUDA device; the CPU runs the kernel's plain version, which counts none).

Prints one JSON line per tree with the card's name and power limit
(``nvidia-smi``) and the counts; exits non-zero when a run fails or gives
outputs that differ from the first run's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, os, subprocess, sys
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import chip_smoke as cs
import repro_torch
from repro_torch.apps.streams import NETWORKS
from repro_torch.kernels.stream_fused import kernel

runs, device = int(sys.argv[3]), sys.argv[4]


def once(name):
    net, got = cs.build_net(NETWORKS, name, cs.SIZES[name])
    prog = repro_torch.compile(net, backend="device", block=cs.BLOCK, device=device)
    prog.device_programs()  # build the kernels off the count
    before = kernel.LAUNCHES
    rep = prog.run()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    return list(got), rep.plink_launches, kernel.LAUNCHES - before


out = {"tree": sys.argv[1], "device": device, "networks": {}}
ok = True
for name in cs.SIZES:
    first, _, _ = once(name)
    row = {}
    for mode in ("quiet", "loaded"):
        spin = []
        if mode == "loaded":
            spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                    for _ in range(len(os.sched_getaffinity(0)))]
        try:
            counts = [once(name) for _ in range(runs)]
        finally:
            for p in spin:
                p.kill()
                p.wait()
        ok = ok and all(o == first for o, _, _ in counts)
        row[mode] = dict(plink=[p for _, p, _ in counts], kernel=[k for _, _, k in counts])
    out["networks"][name] = row
print(json.dumps(out), flush=True)
sys.exit(0 if ok else 1)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="src directories, run in this order")
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip() if args.device.startswith("cuda") else "cpu"
    rc = 0
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, str(Path(tree).resolve()), str(ROOT),
             str(args.runs), args.device],
            capture_output=True, text=True,
        )
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"card": card, **json.loads(line)}), flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
