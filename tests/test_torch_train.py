"""The port's training driver on the CPU: ``run_training(device="cpu")`` with
an injected failure and a resume, the copied data pipeline against the
reference's batch for batch, and the checkpoint's lossless bfloat16 round
trip."""

import math

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.data.pipeline import DataConfig, DataPipeline, SyntheticLM
from repro_torch.launch.train import run_training


def test_training_survives_injected_failure(tmp_path):
    out = run_training(
        device="cpu", reduced=True, steps=6, seq_len=64, fail_at=3,
        ckpt_dir=str(tmp_path), ckpt_every=2, quiet=True,
    )
    assert out["steps"] == 6
    assert out["restarts"] == 1  # recovered from the step-2 checkpoint
    assert out["finite"] and all(math.isfinite(x) for x in out["losses"])
    assert len(out["losses"]) == 3 + 4  # steps 0-2, then 2-5 again from step 2
    assert latest_step(tmp_path) == 6


def test_training_resume_continues_from_checkpoint(tmp_path):
    first = run_training(
        device="cpu", steps=4, global_batch=4, seq_len=64,
        ckpt_dir=str(tmp_path), ckpt_every=2, quiet=True,
    )
    assert first["steps"] == 4 and latest_step(tmp_path) == 4
    out = run_training(
        device="cpu", steps=6, global_batch=4, seq_len=64,
        ckpt_dir=str(tmp_path), ckpt_every=2, quiet=True,
    )
    assert out["steps"] == 6
    assert len(out["losses"]) == 2  # resumed at step 4: only steps 4 and 5 ran
    assert out["finite"]


def test_run_training_device_none_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(steps=1, quiet=True)


def test_data_stream_matches_reference():
    cfg = dict(vocab_size=131, seq_len=48, global_batch=3, seed=7)
    ours = DataPipeline(DataConfig(**cfg)).start()
    theirs = JDataPipeline(JDataConfig(**cfg)).start()
    try:
        for _ in range(4):
            a, b = ours.get_batch(), theirs.get_batch()
            assert a.keys() == b.keys() == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    finally:
        ours.stop()
        theirs.stop()
    gen = SyntheticLM(DataConfig(**cfg))
    gen.next_batch()
    state = gen.state_dict()
    nxt = gen.next_batch()
    again = SyntheticLM(DataConfig(**cfg))
    again.load_state_dict(state)
    assert np.array_equal(again.next_batch()["tokens"], nxt["tokens"])


def test_checkpoint_round_trip_is_lossless(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {
        "params": {
            "w": torch.randn(5, 7, generator=gen).to(torch.bfloat16).requires_grad_(True),
            "scale": torch.randn(7, generator=gen),
        },
        "opt": {"step": torch.tensor(3, dtype=torch.int32)},
    }
    save(tmp_path, 3, tree, extra={"step": 3})
    assert latest_step(tmp_path) == 3
    manifest = (tmp_path / "step_3" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest
    like = {
        "params": {"w": torch.zeros(5, 7, dtype=torch.bfloat16).requires_grad_(True),
                   "scale": torch.zeros(7)},
        "opt": {"step": torch.zeros((), dtype=torch.int32)},
    }
    got, extra = restore(tmp_path, 3, like)
    assert extra == {"step": 3}
    assert torch.equal(got["params"]["w"].view(torch.int16), tree["params"]["w"].view(torch.int16))
    assert got["params"]["w"].requires_grad
    assert torch.equal(got["params"]["scale"], tree["params"]["scale"])
    assert int(got["opt"]["step"]) == 3
