"""What the benchmark may import: nothing under ``bench/`` imports JAX, the
JAX package or ``benchmarks/``; the reference and the yardstick import
nothing of the program; the run's own check fails a process that loaded
JAX or the JAX package, compared by whole top-level names."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from bench.tests import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in (ROOT / "bench").rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_source_imports_jax_the_jax_package_or_benchmarks(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "work"])
def test_the_yardstick_imports_nothing_of_the_program(sub):
    for path in (ROOT / "bench" / sub).rglob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path
        assert top_level_imports(path) <= {"bench", "torch", "math", "typing", "importlib",
                                              "__future__"}


def _forbidden_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
         f"{str(ROOT / 'bench')!r}, {str(ROOT / 'src')!r}]; {code}; import run; "
         f"print(run.forbidden_modules())"],
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_check_names_jax_and_the_jax_package_but_not_the_port():
    assert _forbidden_after("import repro_torch.model.lm") == []
    assert _forbidden_after("import repro") == ["jax", "jaxlib", "repro"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "smollm-135m.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_of_the_benchmark_alone_cannot_run_a_cell(tmp_path):
    """Without the program beside it (a directory of BENCHMARK.json and
    bench/ only), a run fails before it could print a result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    code = ("import sys, time, torch; sys.path.insert(0, '.'); "
            "from bench.tests import tiny_cell; from bench.harness.core import run_cell; "
            "print(run_cell(tiny_cell('smollm-135m.train'), 1, 0.1, False, "
            "torch.device('cpu'), time.perf_counter()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr
    json.loads((tmp_path / "BENCHMARK.json").read_text())
