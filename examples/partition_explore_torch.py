"""The paper's workflow end to end (§III-E/F + §V) on the PyTorch port, twin
of ``examples/partition_explore.py``:

1. author the network once and ``repro_torch.compile`` it,
2. ``Program.profile()`` — host + device actor times (each single-actor
   device step timed on the card), channel-bandwidth curves (Fig. 11),
3. ``Program.explore()`` — solve the MILP across thread-counts x accelerator
   use (Table II / Fig. 7),
4. emit the best partition as an XCF (+ paper-style XML), and
5. ``Program.repartition(best.xcf).run()`` — run the chosen heterogeneous
   partition to verify the prediction, its outputs bitwise a host-only run's
   (TopFilter only compares and selects).  Placement never touches the
   program.

The XCF names the accelerator PE ``tpu-v5e-16x16``, as the reference's
``make_xcf`` does (``core/xcf.py`` is a pinned copy); the port binds that
name to the program's device, which is printed beside the XCF.  Then the
same partitioner applied to an LM layer chain on a 256-chip TPU pod
(pipeline-stage assignment via the optimal chain DP): its times are the
copied cost model's, not a measurement.

    PYTHONPATH=src python examples/partition_explore_torch.py [--device cpu] [--n N]

The device partition runs on ``cuda:0`` unless ``--device`` names another
device; without CUDA it raises, unless ``--device cpu`` is passed.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

import repro_torch
from repro_torch.apps.streams import topfilter
from repro_torch.configs import get_config
from repro_torch.core.partitioner import best_point, explore_lm
from repro_torch.model.layers import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' for the CPU")
    ap.add_argument("--n", type=int, default=20000, help="TopFilter tokens")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "partition_explore")

    net, got = topfilter(args.n)
    prog = repro_torch.compile(net, block=2048, device=device)
    prog.run()  # host-only: the outputs the chosen partition must reproduce
    out_host = list(got)
    print(f"== profiling {net.name} ({len(net)} actors) ==")
    prof = prog.profile(block=2048, bandwidth_sizes=(256, 2048))
    for a in sorted(prog.graph.actors):
        sw = prof.exec_sw.get(a, 0) * 1e3
        hw = prof.exec_hw.get(a, float("nan")) * 1e3
        print(f"  {a:8s} sw={sw:8.2f}ms hw={hw:8.2f}ms")

    print("\n== design-space exploration ==")
    points = prog.explore(
        prof, thread_counts=(1, 2, 3), accel_options=(False, True)
    )
    for p in sorted(points, key=lambda p: p.predicted):
        print(
            f"  threads={p.n_threads} accel={str(p.use_accel):5s} "
            f"predicted={p.predicted*1e3:7.1f}ms hw_actors={p.hw_actors()}"
        )
    bp = best_point(points)
    print("\n== best partition (XCF, paper Listing-2 format) ==")
    print(bp.xcf.to_xml())

    print("== measured run of the best partition ==")
    best = prog.repartition(bp.xcf)  # same program, the solver's placement
    report = best.run()
    out_best = list(got)
    ran_on = {pid: str(dp.device) for pid, dp in best.device_programs().items()}
    for pid, dev in ran_on.items():
        print(f"  partition {pid} ran on {dev}")
    assert np.asarray(out_best).tobytes() == np.asarray(out_host).tobytes(), (
        f"{net.name}: the best partition's outputs are not bitwise the host run's"
    )
    print(
        f"  predicted {bp.predicted*1e3:.1f}ms, measured "
        f"{report.seconds*1e3:.1f}ms, {len(got)} tokens out, outputs_match=True"
    )

    print("\n== the same partitioner on an LM layer chain (256-chip pod) ==")
    plans = {}
    for arch in ("llama3-8b", "qwen3-moe-235b-a22b"):
        plans[arch] = explore_lm(get_config(arch), stage_options=(1, 2, 4, 8))
        for p in plans[arch]:
            print(
                f"  {arch}: stages={p.num_stages} chips/stage={p.chips_per_stage} "
                f"pipeline bottleneck={p.bottleneck_s*1e3:.0f}ms"
            )
    return {"exec_sw": dict(prof.exec_sw), "exec_hw": dict(prof.exec_hw),
            "points": [(p.n_threads, p.use_accel, p.predicted, p.hw_actors())
                       for p in points],
            "best_hw_actors": bp.hw_actors(), "predicted_ms": bp.predicted * 1e3,
            "measured_ms": report.seconds * 1e3, "plink_launches": report.plink_launches,
            "ran_on": ran_on, "tokens": len(out_best), "outputs_match": True,
            "host": out_host, "best": out_best, "plans": plans}


if __name__ == "__main__":
    main()
