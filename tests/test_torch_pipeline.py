"""The port's GPipe pipeline (``distributed/pipeline.py``) over 4 gloo ranks
on the CPU, one stage a rank (``torch_ranks``).

* ``gpipe_apply`` of four tanh stages on 6 microbatches of (5, 16), against
  the reference's ``gpipe_apply`` run as ``tests/test_spmd_subprocess.py``
  runs it (a subprocess with 8 fake CPU devices): within 1e-5 in float32.
* The reduced smollm-135m at 8 blocks in 4 stages of 2 (the reference's
  ``examples/pipeline_lm.py`` setup) against the sequential forward, values
  and the gradient of a block weight through the pipeline.
* On CPU tensors the hops and the masked sum, forward and backward, are
  never staged through the host (the rule is for CUDA tensors on a gloo
  group), and the outputs are bitwise the first run's.  The staging of CUDA
  tensors needs the card: ``chip_smoke.py`` phase 17 holds it
  (``examples/pipeline_lm_torch.py``, 4 ranks on one card).
* ``pipeline_bubble_fraction`` and ``stack_stage_params`` against the
  reference's.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.distributed.pipeline import pipeline_bubble_fraction as jbubble
from repro.distributed.pipeline import stack_stage_params as jstack
from repro_torch.distributed.pipeline import pipeline_bubble_fraction, stack_stage_params
from torch_ranks import JOIN_SECONDS, SRC, spawn

STAGES = 4

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import gpipe_apply, stack_stage_params
    data = np.load(sys.argv[1])
    per_stage = [{"w": jnp.asarray(data["w"][i]), "b": jnp.asarray(data["b"][i])}
                 for i in range(data["w"].shape[0])]
    mesh = jax.make_mesh((len(per_stage),), ("stage",))
    with mesh:
        got = gpipe_apply(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                          stack_stage_params(per_stage), jnp.asarray(data["x"]),
                          mesh=mesh, axis="stage")
    np.save(sys.argv[2], np.asarray(got))
""")


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    data = {"w": (rng.standard_normal((STAGES, 16, 16)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((STAGES, 16)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((6, 5, 16)).astype(np.float32)}
    np.savez(tmp / "tanh.npz", **data)
    res = spawn(tmp, "pipeline", STAGES, {"tanh": str(tmp / "tanh.npz")})
    script = tmp / "ref.py"
    script.write_text(REF_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    done = subprocess.run([sys.executable, str(script), str(tmp / "tanh.npz"),
                           str(tmp / "ref.npy")], env=env, capture_output=True, text=True,
                          timeout=JOIN_SECONDS)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    return data, res, np.load(tmp / "ref.npy")


def test_gpipe_matches_reference(piped):
    data, res, ref = piped
    assert res[0]["tanh"].shape == data["x"].shape
    np.testing.assert_allclose(res[0]["tanh"], ref, atol=1e-5, rtol=0)
    seq = data["x"]
    for i in range(STAGES):
        seq = np.tanh(seq @ data["w"][i] + data["b"][i])
    np.testing.assert_allclose(res[0]["tanh"], seq, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rank", range(STAGES))
def test_every_stage_returns_the_last_stage_outputs(piped, rank):
    _, res, _ = piped
    np.testing.assert_array_equal(res[rank]["tanh"], res[STAGES - 1]["tanh"])
    np.testing.assert_array_equal(res[rank]["lm"], res[STAGES - 1]["lm"])


@pytest.mark.parametrize("rank", range(STAGES))
def test_cpu_tensors_take_the_unstaged_path_bitwise(piped, rank):
    """On CPU tensors over gloo the host-staging rule of the hops and the
    masked sum never fires, forward or backward, and the outputs are
    bitwise those of the pipeline's first run."""
    _, res, _ = piped
    r = res[rank]
    assert r["staged/decided"].size > 0 and not r["staged/decided"].any()
    assert r["staged/y"].tobytes() == r["tanh"].tobytes()


def test_pipelined_lm_matches_sequential_forward(piped):
    _, res, _ = piped
    r = res[0]
    assert r["lm"].shape == r["lm_ref"].shape
    np.testing.assert_allclose(r["lm"], r["lm_ref"], atol=1e-5, rtol=1e-5)


def test_pipelined_lm_gradient_matches_sequential(piped):
    """The hop's backward sends each cotangent one stage back, and the
    masked sum's backward reaches only the last stage's outputs: the weight
    gradient through the pipeline is the sequential one (each rank holds
    the part of its own stage's blocks)."""
    _, res, _ = piped
    got = sum(r["lm_grad"] for r in res)
    np.testing.assert_allclose(got, res[0]["lm_grad_ref"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_micro,n_stages", [(1, 1), (4, 4), (6, 4), (8, 2), (32, 16)])
def test_bubble_fraction_matches_reference(n_micro, n_stages):
    assert pipeline_bubble_fraction(n_micro, n_stages) == jbubble(n_micro, n_stages)


def test_stack_stage_params_matches_reference():
    rng = np.random.default_rng(2)
    per = [{"w": rng.standard_normal((3, 2)).astype(np.float32),
            "b": {"c": rng.standard_normal(4).astype(np.float32)}} for _ in range(3)]
    got = stack_stage_params([jax.tree.map(torch.from_numpy, p) for p in per])
    want = jstack(per)
    assert np.array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert np.array_equal(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))


def test_pipeline_module_imports_no_jax():
    text = (Path(SRC) / "repro_torch/distributed/pipeline.py").read_text()
    assert "import jax" not in text and "from repro." not in text
