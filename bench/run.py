"""Run one cell of the PyTorch port's benchmark once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's files are found by name
(``bench/workloads/<cell>.json`` and the configuration and traffic mix it
names); the weights and inputs come from ``--seed``; set-up, including the
first steps that the reference checks, is timed as ``setup_s``; then the
window runs ``--seconds``.  With ``--trace 1`` the window runs as it does
untraced, then the traffic's ``trace_calls`` more calls run under
``torch.profiler`` with the program's spans recorded, the device time by
program span is printed to standard error, and the per-layer metrics are
read from both windows.  The last line of standard output is the result;
the numbers compared with the reference, each beside its limit, are the
last lines of standard error.

Exits 2 with no result without a CUDA card, and 3 if a JAX package or the
JAX reference package was loaded.  Kernel build and compile caches live at
fixed paths inside the checkout (``bench/.gitignore``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))
os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.harness import cells

    cell = cells.load_cell(args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell {args.workload} needs {chips} CUDA card(s); {n} available",
              file=sys.stderr)
        return 2
    from bench.harness.core import run_cell

    torch.set_num_threads(1)  # one process, few threads: the host path is the program's
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                      T_START)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}: the port must not use JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    for name, value in result["not_compared"].items():
        print(f"reading {name} {value!r} not compared", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
