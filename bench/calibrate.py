"""Readings that set a cell's limits, on the card, in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2]

For each of ``--seeds``: the program's set-up and a short window at the
cell's own load, the float32 reference, and the numbers that decide
``correct`` (the lower readings).  For each of ``--control-seeds``: the
control, the reference computed with float8 products
(``reference/precision.py``) put in the program's place, held to the
float32 reference the same way (an upper reading).  For each of
``--fault-seeds``: each fault the cell's driver plants in the reference
(``faults``; a training cell's half batch), held to the float32 reference.
One JSON line each, to standard output.  The driver is the traffic kind's
(``bench/harness/<kind>.py``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import cells
    from bench.harness.core import Run, driver
    from bench.harness.trace import Tracer
    from bench.reference.precision import Precision, float32_products

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = cells.load_cell(args.workload)
    drv = driver(cell["traffic"]["kind"])
    f32, fp8 = Precision("float32"), Precision("fp8")

    def emit(what, seed, run, got, ref, t0):
        line = {"cell": args.workload, "what": what, "seed": seed,
                "numbers": drv.numbers(run, got, ref), "s": time.perf_counter() - t0}
        line.update(drv.details(run, got, ref))
        print(json.dumps(line), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        t0 = time.perf_counter()
        run = Run(cell, seed, args.seconds, device, Tracer(False, device))
        got = None
        if seed in args.seeds:
            prog = drv.setup(run)
            run.window = drv.window(run, prog, seconds=args.seconds)
            got = drv.readings(prog)
            for key in ("step", "params", "state"):
                prog.pop(key, None)
            del prog
            gc.collect()
            torch.cuda.empty_cache()
        float32_products()
        ref = drv.reference(run, got, f32)
        if got is not None:
            emit("program", seed, run, got, ref, t0)
        if seed in args.control_seeds:
            emit("control_fp8", seed, run, drv.as_served(drv.reference(run, got, fp8)), ref, t0)
        if seed in args.fault_seeds:
            for name, faulty in drv.faults(run, got, f32).items():
                emit(f"fault_{name}", seed, run, faulty, ref, t0)
        del got, ref
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "total_s": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
