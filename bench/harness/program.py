"""The system under test, as the benchmark calls it: the PyTorch port
``repro_torch`` (under ``src/`` of the checkout), its model configuration,
its training and prefill steps, and the recorder of its spans.  Nothing
else of the program is used.

Tests replace these functions to break the timed path underneath a run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Dict

import torch

from bench.harness.cells import ROOT
from bench.harness.weights import flatten, nest


def _port():
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"the program under test, repro_torch, is not importable from "
                           f"{src}: {e}") from e


def model_config(model: dict):
    """The port's ``ModelConfig`` with every field the configuration file's
    ``model`` block sets."""
    _port()
    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(model) - fields)
    if unknown:
        raise ValueError(f"configuration keys the program does not know: {unknown}")
    return ModelConfig(**model)


def check_layout(cfg, flat: Dict[str, torch.Tensor]) -> None:
    """Fail unless the program takes exactly these parameters (paths,
    shapes and types)."""
    from repro_torch.model import lm

    want = {k: (tuple(t.shape), t.dtype) for k, t in flatten(lm.abstract_model(cfg)).items()}
    got = {k: (tuple(t.shape), t.dtype) for k, t in flat.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the program's parameters differ from the benchmark's: {diff[:6]}")


def params_tree(flat: Dict[str, torch.Tensor], train: bool) -> dict:
    if train:
        flat = {k: t.requires_grad_(True) for k, t in flat.items()}
    return nest(flat)


def train_step(cfg, opt: dict):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig

    return make_train_step(cfg, OptConfig(**opt))


def init_opt_state(params: dict, opt: dict) -> dict:
    from repro_torch.optim import OptConfig, init_opt_state as init

    return init(params, OptConfig(**opt))


def prefill_step(cfg):
    """``prefill(params, {"tokens": (B, S)}) -> (last-token logits (B, Vp)
    float32, cache)``."""
    from repro_torch.launch.steps import make_prefill_step

    return make_prefill_step(cfg)


@contextlib.contextmanager
def recording():
    """The program's span recorder, active inside the block: while the
    profiler records, each span the program opens lies in its trace.
    Yields the recorder (``drops()``: events its rings lost)."""
    _port()
    from repro_torch.observability import TraceRecorder, activate

    with activate(TraceRecorder()) as rec:
        yield rec
