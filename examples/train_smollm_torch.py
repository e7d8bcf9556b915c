"""End-to-end training driver demo on the PyTorch port: smollm-135m
(reduced by default) for a few hundred steps with async checkpointing, an
injected node failure at step 60 (recovered from the last checkpoint), and
gradient accumulation.  Twin of ``examples/train_smollm.py``.

The kernels it runs on a card: the flash-attention forward, dQ and dK/dV,
and RMSNorm.

    PYTHONPATH=src python examples/train_smollm_torch.py [--steps 200] [--full] [--device cpu]

``--full`` trains the published widths and depth.  The checkpoints go to a
temporary directory that is removed at the end.  Runs on ``cuda:0`` unless
``--device`` names another device; without CUDA it raises, unless
``--device cpu`` is passed.
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.train import run_training
from repro_torch.model.layers import resolve_device

FAIL_AT = 60


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true", help="the published widths and depth")
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "train_smollm")
    with tempfile.TemporaryDirectory(prefix="train_smollm_ckpt_") as ckpt_dir:
        out = run_training(
            args.arch,
            steps=args.steps,
            global_batch=16,
            seq_len=128,
            accum_steps=2,
            ckpt_every=25,
            fail_at=FAIL_AT,
            lr=2e-3,
            reduced=not args.full,
            ckpt_dir=ckpt_dir,
            device=device,
        )
    print(
        f"\n== {out['arch']}: {out['steps']} steps, {out['restarts']} restart(s) "
        f"(injected failure recovered), loss {out['loss_first']:.3f} -> "
        f"{out['loss_last']:.3f}, improved={out['improved']} =="
    )
    assert out["finite"], "non-finite loss"
    assert out["steps"] == args.steps and out["restarts"] == int(args.steps > FAIL_AT), (
        f"{out['steps']} steps and {out['restarts']} restart(s)"
    )
    return out


if __name__ == "__main__":
    main()
