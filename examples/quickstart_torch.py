"""Quickstart on the PyTorch port: train a tiny byte-level LM on text and
sample from it.  Twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--steps 300]

The model stack, top down, as the reference's tour describes it, under
``repro_torch``: the byte tokenizer and the text data pipeline
(``data/``), the logical-axis rules and ``shard_ctx`` over the test mesh
(``distributed/sharding.py``, ``launch/mesh.py``), the train step with
AdamW (``launch/steps.py``, ``optim/``; attention through the CUDA flash
kernels and RMSNorm through its kernel on a card) and greedy generation
(``launch/serve.py::make_generate``).  For the dataflow stack's author ->
compile -> profile -> repartition loop, see
``examples/heterogeneous_stream_torch.py`` and
``examples/partition_explore_torch.py``.

The mesh needs a ``torch.distributed`` process group: where none exists,
this script starts a one-rank group (NCCL on a card, gloo with ``--device
cpu``) and destroys it at the end; a group that already exists is used and
left as it is.  Runs on ``cuda:0`` unless ``--device`` names another device;
without CUDA it raises, unless ``--device cpu`` is passed.
"""

import argparse
import contextlib
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.data.tokenizer import VOCAB, decode, encode
from repro_torch.distributed.sharding import (
    DTensor,
    defs_shardings,
    make_rules,
    place,
    shard_ctx,
)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serve import make_generate
from repro_torch.launch.steps import make_train_step
from repro_torch.model import lm
from repro_torch.model.layers import resolve_device
from repro_torch.optim import OptConfig, init_opt_state

TEXT = (
    "the actor machine remembers the conditions it has already tested. "
    "a dataflow program is a network of actors connected by channels. "
    "streamblocks compiles the same program to software and hardware. "
) * 4


@contextlib.contextmanager
def process_group(device: torch.device):
    """A one-rank process group for the mesh, unless one exists already."""
    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="quickstart_group_")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.FileStore(str(Path(tmp) / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _value(t: torch.Tensor) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default cuda:0; 'cpu' for the CPU")
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "quickstart")
    n_steps = args.steps

    cfg = ModelConfig(
        name="bytelm", num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=VOCAB, tie_embeddings=True,
    )
    with process_group(device):
        mesh = make_test_mesh()
        rules = make_rules(cfg, mesh)
        opt = OptConfig(lr=3e-3, warmup_steps=20, total_steps=n_steps)
        data = DataPipeline(
            DataConfig(vocab_size=VOCAB, seq_len=128, global_batch=16,
                       kind="text", text=TEXT)
        ).start()

        params = lm.init_model(cfg, 0, device=device)
        params = place(params, defs_shardings(lm.model_defs(cfg), mesh, rules))
        opt_state = init_opt_state(params, opt)
        step = make_train_step(cfg, opt)

        losses = []
        try:
            for i in range(n_steps):
                batch = data.get_batch()
                with shard_ctx(mesh, rules):
                    params, opt_state, m = step(params, opt_state, batch)
                losses.append(_value(m["loss"]))
                if i % 50 == 0 or i == n_steps - 1:
                    print(f"step {i:4d}  loss {losses[-1]:.3f}")
        finally:
            data.stop()

        prompt = "the actor machine "
        ids = torch.tensor([encode(prompt)[:-1]], dtype=torch.int32, device=device)  # drop EOS
        gen = make_generate(cfg, mesh, rules, max_new=48)
        out, steps = gen(params, ids)
        completion = decode(list(out[0][: int(steps)]))
    print("prompt:    ", prompt)
    print("completion:", completion)
    return {"losses": losses, "loss_first": losses[0], "loss_last": losses[-1],
            "prompt": prompt, "completion": completion, "tokens": out.cpu().numpy(),
            "steps": int(steps)}


if __name__ == "__main__":
    main()
