"""Heterogeneous streaming demo (paper Fig. 6) on the PyTorch port: the same
dataflow program run (a) all on host threads and (b) with its compute actors
moved to the device partition behind a PLink, on a CUDA card — no code
change, only the configuration differs.  Twin of
``examples/heterogeneous_stream.py``.

With the frontend this is the whole program: author once,
``repro_torch.compile``, then ``repartition`` to a different placement.  The
device partition runs each fused region as one generated CUDA kernel
(``repro_torch.kernels.stream_fused``).

    PYTHONPATH=src python examples/heterogeneous_stream_torch.py [--device cpu]

The device partition runs on ``cuda:0`` unless ``--device`` names another
device; without CUDA it raises, unless ``--device cpu`` is passed.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

import repro_torch
from repro_torch.apps.streams import bitonic8, idct8
from repro_torch.model.layers import resolve_device

# compare-only networks: the device outputs equal the host's bit for bit
EXACT = {"Bitonic8"}


def run(name, builder, n, device):
    net, got = builder(n)
    prog = repro_torch.compile(net, block=4096, device=device)  # host-only placement

    r_host = prog.run()
    out_host = list(got)

    hetero = prog.repartition(backend="device")  # same network, new placement
    r_het = hetero.run()
    out_dev = list(got)

    # host actors compute in python float64, the device partition in float32
    assert len(out_host) == len(out_dev) and np.allclose(out_host, out_dev, atol=1e-3), (
        f"{name}: heterogeneous run diverged!"
    )
    if name in EXACT:
        assert np.asarray(out_dev).tobytes() == np.asarray(out_host).tobytes(), (
            f"{name}: compare-only network, device outputs not bitwise the host's"
        )
    print(
        f"{name:10s} tokens={len(got):6d}  host={r_host.seconds*1e3:7.1f}ms  "
        f"hetero={r_het.seconds*1e3:7.1f}ms  "
        f"plink_launches={r_het.plink_launches}  outputs_match=True"
    )
    return {"tokens": len(out_dev), "host_ms": r_host.seconds * 1e3,
            "hetero_ms": r_het.seconds * 1e3, "plink_launches": r_het.plink_launches,
            "outputs_match": True, "host": out_host, "device": out_dev}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "heterogeneous_stream")
    print("same program, two placements (host-only vs PLink+device):")
    return {"Bitonic8": run("Bitonic8", bitonic8, 1000, device),
            "IDCT8": run("IDCT8", idct8, 1000, device)}


if __name__ == "__main__":
    main()
