"""Batched serving demo on the PyTorch port: prefill + idleness-terminated
decode loop for an attention arch, an (attention-free) SSM arch and a MoE
arch.  Twin of ``examples/serve_decode.py``.

The kernels it runs on a card: RMSNorm on all three, the SSD scan in
mamba2-130m's prefill, the grouped expert matmul in deepseek-moe-16b's.

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu] [--full]

The reduced configs by default; ``--full`` serves the published widths and
depth (deepseek-moe-16b: 33.8 GB of bf16 weights).  Runs on ``cuda:0``
unless ``--device`` names another device; without CUDA it raises, unless
``--device cpu`` is passed.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.serve import run_serving
from repro_torch.model.layers import resolve_device

ARCHS = ("smollm-135m", "mamba2-130m", "deepseek-moe-16b")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' for the CPU")
    ap.add_argument("--full", action="store_true", help="the published widths and depth")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "serve_decode")
    return {arch: run_serving(arch, batch=4, prompt_len=16, max_new=16,
                              reduced=not args.full, device=device)
            for arch in ARCHS}


if __name__ == "__main__":
    main()
