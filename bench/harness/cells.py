"""Find a cell's files by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<mix>.json``); a per-layer metric's reader is
``metrics/<metric>.py``.  Later cells add files; none is edited."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} (looked for {path})")
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """{"workload", "config", "traffic"} of the cell ``name``."""
    workload = load_json("workloads", name)
    if workload["name"] != name:
        raise ValueError(f"workloads/{name}.json names itself {workload['name']!r}")
    return {"workload": workload, "config": load_json("configs", workload["config"]),
            "traffic": load_json("traffic", workload["traffic"])}


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_reader(name: str) -> Callable[[object], Optional[float]]:
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for the metric {name!r} (looked for {path})")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
