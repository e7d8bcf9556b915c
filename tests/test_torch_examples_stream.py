"""The stream example twins (``examples/*_torch.py``) against the reference
examples, on the CPU (``--device cpu``), and the rules every twin keeps.

* ``heterogeneous_stream_torch``: the host and device outputs of Bitonic8
  and IDCT8 against the reference example's ``run`` on the same n (its
  device run's outputs, caught through the builder): Bitonic8 (compare-only)
  bitwise, IDCT8 within the example's ``atol=1e-3``.
* ``partition_explore_torch`` at n = 2000: the best partition's measured
  run bitwise the reference's host run of TopFilter (compare-only), and the
  ``explore_lm`` plans for llama3-8b and qwen3-moe-235b-a22b equal to the
  reference's.
* Every twin imports neither ``repro`` nor ``jax`` (read from its AST), and
  raises without CUDA unless given ``--device cpu``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
from repro.apps.streams import topfilter as jtopfilter
from repro.configs import get_config as jget_config
from repro.core.partitioner import explore_lm as jexplore_lm
from torch_examples import EXAMPLES, load_example

TWINS = ("heterogeneous_stream", "partition_explore", "pipeline_lm", "quickstart",
         "serve_decode", "train_smollm")


def _bits(values) -> bytes:
    return np.asarray(values, np.float64).tobytes()


@pytest.fixture(scope="module")
def hetero():
    """The twin's outputs, and the reference example's device outputs."""
    got = load_example("heterogeneous_stream_torch").main(["--device", "cpu"])
    ref_mod = load_example("heterogeneous_stream")
    ref = {}
    for name, builder in (("Bitonic8", ref_mod.bitonic8), ("IDCT8", ref_mod.idct8)):
        def catch(n, builder=builder, name=name):
            net, out = builder(n)
            ref[name] = out  # filled by each run; the device run's last
            return net, out

        ref_mod.run(name, catch, 1000)
    return got, ref


@pytest.mark.parametrize("name", ["Bitonic8", "IDCT8"])
def test_heterogeneous_stream_matches_reference_example(hetero, name):
    got, ref = hetero
    run = got[name]
    assert run["outputs_match"] and run["plink_launches"] >= 1
    assert run["tokens"] == len(ref[name]) == 8000
    for side in ("host", "device"):
        if name == "Bitonic8":
            assert _bits(run[side]) == _bits(ref[name]), side
        else:
            np.testing.assert_allclose(run[side], ref[name], atol=1e-3, rtol=0)


def test_heterogeneous_stream_bitonic_device_bitwise_host(hetero):
    got, _ = hetero
    assert _bits(got["Bitonic8"]["device"]) == _bits(got["Bitonic8"]["host"])


@pytest.fixture(scope="module")
def explored():
    return load_example("partition_explore_torch").main(["--device", "cpu", "--n", "2000"])


def test_partition_explore_best_run_bitwise_reference_host(explored):
    net, out = jtopfilter(2000)
    repro.compile(net, block=2048).run()
    assert explored["outputs_match"] and explored["tokens"] == len(out) > 0
    assert _bits(explored["best"]) == _bits(out)
    assert _bits(explored["host"]) == _bits(out)
    for _pid, dev in explored["ran_on"].items():
        assert dev == "cpu"
    assert bool(explored["ran_on"]) == bool(explored["best_hw_actors"])


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-235b-a22b"])
def test_partition_explore_lm_plans_match_reference(explored, arch):
    want = jexplore_lm(jget_config(arch), stage_options=(1, 2, 4, 8))
    got = explored["plans"][arch]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.num_stages, g.chips_per_stage, g.stage_of_layer, g.names) == (
            w.num_stages, w.chips_per_stage, w.stage_of_layer, w.names)
        assert g.bottleneck_s == w.bottleneck_s


def test_partition_explore_prints_every_design_point(explored):
    points = explored["points"]
    assert len(points) == 6  # 1-3 threads x with and without the device
    assert explored["predicted_ms"] == min(p[2] for p in points) * 1e3


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_repro_nor_jax(name):
    path = EXAMPLES / f"{name}_torch.py"
    mods = list(_imports(path))
    assert any(m.startswith("repro_torch") for m in mods)
    bad = [m for m in mods if m.split(".")[0] in ("repro", "jax", "jaxlib")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is the card")
    mod = load_example(f"{name}_torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--device", "cuda"])

