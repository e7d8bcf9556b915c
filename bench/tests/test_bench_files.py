"""BENCHMARK.json against the contract's schema, and every cell's files,
configuration, traffic mix and metric reader found by name."""

import json
import re

import pytest

from bench.harness import cells
from bench.tests import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert all((ROOT / p).is_dir() and not p.endswith("_torch") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def _entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[key]:
            yield key, e


@pytest.mark.parametrize("key,entry", list(_entries()), ids=lambda x: str(x)[:40])
def test_names_units_and_texts(key, entry):
    assert NAME.match(entry["name"]), entry["name"]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    for k in TEXT_KEYS:
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[key]
    assert set(entry) <= allowed


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_config_is_used_and_found_by_name():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"bench/configs/{c['name']}.json"
        data = cells.load_json("configs", c["name"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name_and_matches_its_file(w):
    cell = cells.load_cell(w["name"])
    for k in ("config", "traffic", "chips", "why"):
        assert cell["workload"][k] == w[k]
    assert w["chips"] in (1, 4)
    assert cell["traffic"]["name"] == w["traffic"]
    kind = cell["traffic"]["kind"]
    assert (ROOT / "bench" / "harness" / f"{kind}.py").is_file()  # its driver, by name
    assert isinstance(cell["traffic"]["trace_calls"], int) and cell["traffic"]["trace_calls"] >= 1
    assert "failed_calls" not in cell["workload"]["limits"]  # core's own check, limit 0
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_four_chip_cells_are_at_most_a_quarter():
    n4 = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert n4 <= max(1, len(SPEC["workloads"]) // 4)


def test_every_metric_has_a_reader_and_fitting_fields():
    cells_named = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells_named)) <= cells_named
        assert callable(cells.metric_reader(m["name"]))
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells_named
        moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells_named))
        assert callable(cells.metric_reader(m["name"]))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(w):
    from bench.harness.core import metrics_of

    e2e = [m["name"] for m in metrics_of(w["name"], False, SPEC)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert metrics_of(w["name"], True, SPEC)


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "bench").rglob("*"):
        if ".cache" in p.parts or "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
