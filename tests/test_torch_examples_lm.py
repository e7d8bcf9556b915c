"""The LM example twins (``examples/*_torch.py``) on the CPU (``--device
cpu``), held to the JAX package.

The reference's ``train_smollm``, ``serve_decode`` (and ``quickstart``,
``tests/test_torch_examples_quickstart.py``) build a mesh and fail under
this JAX version, as do their three ``tests/test_system.py`` tests, so those
twins are held to the reference's unsharded functions and to the system
tests' own contracts:

* ``train_smollm_torch --steps 80``: 80 steps, one restart (the failure
  injected at step 60), the loss improved; and the port's ``run_training``
  resuming from a checkpoint as ``test_training_resume_continues`` asks.
* ``serve_decode_torch`` on the reduced configs: outputs ``(4, 16)``
  with ``1 <= steps <= 16``, the tokens equal to a greedy loop of the
  reference's ``lm.prefill`` / ``lm.decode_step`` with the twin's
  parameters carried across (``params_to_numpy``).
* ``pipeline_lm_torch`` (4 gloo ranks): the stage map equals the reference
  example's, and the pipelined output, the twin's parameters carried
  across, is held to the reference's sequential ``block_fwd`` scan within
  the example's 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.partitioner import explore_lm as jexplore_lm
from repro.model import lm as jlm
from repro.model.blocks import block_fwd as jblock_fwd
from repro_torch.configs import get_config
from repro_torch.launch.train import run_training
from repro_torch.model import lm
from repro_torch.model.convert import params_to_numpy
from torch_examples import load_example


def jax_params(tparams, jcfg):
    """The port's parameters as the JAX model's arrays, in its dtypes."""
    shapes = jax.eval_shape(lambda: jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), params_to_numpy(tparams), shapes)


@pytest.fixture(autouse=True)
def two_threads():
    """The reduced models' ops are small: more CPU threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_train_smollm_survives_failure_and_improves():
    out = load_example("train_smollm_torch").main(["--device", "cpu", "--steps", "80"])
    assert out["steps"] == 80 and out["device"] == "cpu"
    assert out["restarts"] == 1  # the failure injected at step 60, recovered
    assert out["finite"] and out["improved"], (out["loss_first"], out["loss_last"])
    assert out["tokens_per_step"] == 16 * 128


def test_training_resume_continues(tmp_path):
    run_training("smollm-135m", steps=10, global_batch=4, seq_len=32,
                 ckpt_dir=str(tmp_path), ckpt_every=5, quiet=True, device="cpu")
    out = run_training("smollm-135m", steps=14, global_batch=4, seq_len=32,
                       ckpt_dir=str(tmp_path), ckpt_every=5, quiet=True, device="cpu")
    assert len(out["losses"]) == 4  # resumed from step 10


@pytest.fixture(scope="module")
def served():
    return load_example("serve_decode_torch").main(["--device", "cpu"])


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m", "deepseek-moe-16b"])
def test_serve_decode_matches_reference_greedy_loop(served, arch):
    out = served[arch]
    steps = out["steps"]
    assert 1 <= steps <= 16 and out["output"].shape == (4, 16)
    tcfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    jp = jax_params(lm.init_model(tcfg, 0, device="cpu"), jcfg)  # the twin's parameters
    prompts, eos, max_new = out["prompts"], 2, 16
    S_p, B = prompts.shape[1], prompts.shape[0]
    prefill = jax.jit(lambda p, t: jlm.prefill(p, jcfg, tokens=t))
    decode = jax.jit(lambda p, c, t, i: jlm.decode_step(p, jcfg, c, t, i))
    logits, small = prefill(jp, jnp.asarray(prompts))
    big = jlm.init_cache(jcfg, B, S_p + max_new)
    cache = jax.tree.map(lambda b, s: s.astype(b.dtype) if b.shape == s.shape else jnp.pad(
        s.astype(b.dtype), [(0, x - y) for x, y in zip(b.shape, s.shape)]), big, small)
    tok = np.asarray(jnp.argmax(logits, -1), np.int32)
    want, done = [tok], tok == eos
    for i in range(1, max_new):
        if done.all():  # the idleness rule
            break
        logits, cache = decode(jp, cache, jnp.asarray(tok), jnp.int32(S_p + i - 1))
        tok = np.where(done, eos, np.asarray(jnp.argmax(logits, -1), np.int32))
        want.append(tok)
        done = done | (tok == eos)
    assert steps == len(want)
    np.testing.assert_array_equal(out["output"][:, :steps], np.stack(want, axis=1))


@pytest.fixture(scope="module")
def piped():
    return load_example("pipeline_lm_torch").main(["--device", "cpu"])


def test_pipeline_lm_stage_map_matches_reference_example(piped):
    mod = load_example("pipeline_lm_torch")
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), num_layers=8)
    want = jexplore_lm(jcfg, seq_len=mod.S, global_batch=mod.B, total_chips=mod.N_STAGES,
                       stage_options=(mod.N_STAGES,))[0].stage_of_layer
    assert piped["stage_map"] == want == [0, 0, 0, 0, 1, 1, 2, 2, 3, 3]
    assert piped["bubble"] == pytest.approx(3 / 7)


def test_pipeline_lm_matches_reference_sequential_forward(piped):
    mod = load_example("pipeline_lm_torch")
    tcfg = mod.config()
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), num_layers=8)
    jp = jax_params(lm.init_model(tcfg, 0, device="cpu"), jcfg)  # the twin's parameters
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (mod.B, mod.S))
    x = jnp.take(jp["embed"]["tok"], jnp.asarray(tokens), axis=0).astype(jcfg.dtype)
    positions = jnp.arange(mod.S, dtype=jnp.int32)
    kind = jcfg.block_kind(0)

    def body(h, pslice):
        y, _, _ = jblock_fwd(pslice, h, kind, jcfg, positions)
        return y, None

    y_ref, _ = jax.lax.scan(body, x, jp["layers"]["pos0"])
    got = piped["output"]
    assert got.shape == (mod.B, mod.S, jcfg.d_model)
    err = float(np.max(np.abs(got - np.asarray(y_ref, np.float32))))
    assert err < mod.TOL, err
    assert piped["max_err"] < mod.TOL and piped["grad_err"] < mod.TOL


def test_pipeline_lm_ranks_report_their_launches(piped):
    assert sorted(piped["launches"]) == [0, 1, 2, 3]
    for counts in piped["launches"].values():
        assert set(counts) == {"forward", "grad"}
        assert set(counts["forward"]) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                          "rmsnorm"}
