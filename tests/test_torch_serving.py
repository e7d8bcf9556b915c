"""The port's LM serving path against the JAX package, and its own contracts.

On ``smollm-135m.reduced()`` (attention decode) and ``mamba2-130m.reduced()``
(the SSM mixer: the SSD scan in prefill, the single-step recurrence in
decode), with weights carried across by ``params_from_numpy``:

* ``prefill`` + ``decode_step`` against the JAX ``lm.prefill`` /
  ``lm.decode_step`` in float32, within 1e-4 (plain path and kernel path:
  the kernels' plain versions on the CPU);
* prefill + teacher-forced decode against the port's own full forward, at
  the reference's tolerances (``tests/test_lm_consistency.py``: 2e-2 for the
  prefill logits, 3e-2 for decode) in the configs' bfloat16;
* the ``ServingEngine``'s tokens equal the JAX ``ServingEngine``'s (float32,
  the same params and prompts), and the port's engine equals its own
  isolated generation (``tests/test_serving_engine.py``'s contract);
* ``make_generate`` equals a loop of the JAX ``prefill``/``decode_step``
  (the JAX ``run_serving`` builds a mesh, which fails in this JAX version);
* without CUDA, the entry points refuse the default device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.model import lm as jlm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.launch.serve import make_generate, prefill_cache, run_serving
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.model import lm
from repro_torch.model.convert import params_from_numpy
from repro_torch.serving import Request, ServingEngine

ARCHS = ["smollm-135m", "mamba2-130m", "deepseek-moe-16b", "jamba-v0.1-52b",
         "qwen3-moe-235b-a22b"]
# the SSM configs' reduced chunk is 8: prompts of at most 8 tokens or a multiple of 8
ATTN_LENS, SSM_LENS = (5, 9, 7, 12, 4), (5, 8, 7, 16, 4)
PROMPT_LENS = {"smollm-135m": ATTN_LENS, "mamba2-130m": SSM_LENS,
               "deepseek-moe-16b": ATTN_LENS, "jamba-v0.1-52b": SSM_LENS,
               "qwen3-moe-235b-a22b": ATTN_LENS}


def _cfgs(arch, mode="cuda", dtype="float32"):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype, param_dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, param_dtype=dtype,
                               use_kernels=mode)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(seed))
    as_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jparams, params_from_numpy(as_np, tcfg, device="cpu")


def _jax_steps(jcfg):
    """The JAX prefill and decode step, jitted (each eager call would trace
    the layer scan anew)."""
    return (jax.jit(lambda p, t: jlm.prefill(p, jcfg, tokens=t)),
            jax.jit(lambda p, c, t, i: jlm.decode_step(p, jcfg, c, t, i)))


def _splice_np(big, small):
    """The reference's splice: pad every axis where the shapes differ."""
    def one(b, s):
        if b.shape == s.shape:
            return s.astype(b.dtype)
        return jnp.pad(s.astype(b.dtype), [(0, x - y) for x, y in zip(b.shape, s.shape)])

    return jax.tree.map(one, big, small)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["off", "cuda"])
def test_prefill_and_decode_match_reference(arch, mode):
    jcfg, tcfg = _cfgs(arch, mode)
    jparams, tparams = _params(jcfg, tcfg)
    B, S0, S = 2, 8, 13
    tokens = np.random.default_rng(1).integers(3, jcfg.vocab_size, (B, S)).astype(np.int32)
    jprefill, jdecode = _jax_steps(jcfg)
    jlog, jcache = jprefill(jparams, jnp.asarray(tokens[:, :S0]))
    tlog, tcache = make_prefill_step(tcfg)(tparams, {"tokens": torch.from_numpy(tokens[:, :S0])})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    jcache = _splice_np(jlm.init_cache(jcfg, B, S), jcache)
    _, big = prefill_cache(tparams, tcfg, torch.from_numpy(tokens[:, :S0]), S)
    step = make_decode_step(tcfg)
    for i in range(S0, S):
        # scalar positions first, then per-slot (B,) positions
        jpos = jnp.int32(i) if i % 2 else jnp.full((B,), i, jnp.int32)
        tpos = i if i % 2 else torch.full((B,), i, dtype=torch.int32)
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tokens[:, i]), jpos)
        tlog, big = step(tparams, big, torch.from_numpy(tokens[:, i]), tpos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{arch} {mode} pos {i}")


def _full_logits(params, cfg, tokens):
    with torch.no_grad():
        hidden, _, _ = lm.forward_hidden(params, cfg, tokens)
        return torch.matmul(hidden.float(), lm._head_w(params).float()) + lm._vocab_mask(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    cfg = get_config(arch).reduced()  # bfloat16, use_kernels="cuda" (plain on the CPU)
    params = lm.init_model(cfg, 1, device="cpu")
    B, S0, S = 2, 8, 16
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    )
    ref = _full_logits(params, cfg, tokens)
    logits, cache = prefill_cache(params, cfg, tokens[:, :S0], S)
    np.testing.assert_allclose(logits.numpy(), ref[:, S0 - 1].numpy(), atol=2e-2, rtol=2e-2)
    step = make_decode_step(cfg)
    for i in range(S0, S):
        logits, cache = step(params, cache, tokens[:, i], i)
        np.testing.assert_allclose(logits.numpy(), ref[:, i].numpy(), atol=3e-2, rtol=3e-2,
                                   err_msg=f"{arch} pos {i}")


def _requests(arch, cfg, cls):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS[arch]]
    max_news = [6, 10, 4, 8, 5]
    return prompts, max_news, [cls(rid=i, prompt=p, max_new=m)
                               for i, (p, m) in enumerate(zip(prompts, max_news))]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference_engine(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(jcfg, tcfg)
    _, _, jreqs = _requests(arch, jcfg, JRequest)
    _, _, treqs = _requests(arch, tcfg, Request)
    jeng = JServingEngine(jcfg, jparams, slots=2, max_len=48)
    teng = ServingEngine(tcfg, tparams, slots=2, max_len=48, device="cpu")
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jdone = {r.rid: r.output for r in jeng.run()}
    tdone = {r.rid: r.output for r in teng.run()}
    assert len(tdone) == len(treqs)
    assert tdone == jdone
    assert teng.steps == jeng.steps


def _isolated(cfg, params, prompt, max_new, eos_id=2, max_len=96):
    tokens = torch.as_tensor(prompt, dtype=torch.int32)[None, :]
    logits, cache = prefill_cache(params, cfg, tokens, max_len)
    out = [int(torch.argmax(logits[0]))]
    pos = tokens.shape[1]
    step = make_decode_step(cfg)
    while out[-1] != eos_id and len(out) < max_new and pos < max_len - 1:
        logits, cache = step(params, cache, torch.tensor([out[-1]], dtype=torch.int32), pos)
        out.append(int(torch.argmax(logits[0])))
        pos += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_isolated_generation(arch):
    cfg = get_config(arch).reduced()
    params = lm.init_model(cfg, 0, device="cpu")
    prompts, max_news, reqs = _requests(arch, cfg, Request)
    engine = ServingEngine(cfg, params, slots=2, max_len=96, device="cpu")
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert len(done) == len(reqs)
    serial_steps = sum(len(r.output) - 1 for r in done)
    assert engine.steps < serial_steps  # slots genuinely shared the ticks
    for r in sorted(done, key=lambda r: r.rid):
        want = _isolated(cfg, params, prompts[r.rid], max_news[r.rid])
        assert r.output == want, f"request {r.rid}: {r.output} != {want}"


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_steps(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(jcfg, tcfg)
    B, S_p, max_new, eos = 3, 8, 7, 2
    prompts = np.random.default_rng(5).integers(3, jcfg.vocab_size, (B, S_p)).astype(np.int32)
    jprefill, jdecode = _jax_steps(jcfg)
    logits, cache = jprefill(jparams, jnp.asarray(prompts))
    cache = _splice_np(jlm.init_cache(jcfg, B, S_p + max_new), cache)
    tok = np.asarray(jnp.argmax(logits, -1), np.int32)
    want, done = [tok], tok == eos
    for i in range(1, max_new):
        logits, cache = jdecode(jparams, cache, jnp.asarray(tok), jnp.int32(S_p + i - 1))
        tok = np.where(done, eos, np.asarray(jnp.argmax(logits, -1), np.int32))
        want.append(tok)
        done = done | (tok == eos)
    out, steps = make_generate(tcfg, None, None, max_new=max_new, eos_id=eos)(
        tparams, torch.from_numpy(prompts))
    assert steps == max_new and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.stack(want, axis=1))


def test_run_serving_on_cpu_and_the_device_rule():
    out = run_serving("mamba2-130m", batch=2, prompt_len=8, max_new=4, device="cpu",
                      quiet=True)
    assert out["output"].shape == (2, 4) and out["device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_serving("mamba2-130m", batch=1, prompt_len=8, max_new=2, quiet=True)
        cfg = get_config("mamba2-130m").reduced()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(cfg, lm.init_model(cfg, 0, device="cpu"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lm.init_cache(cfg, 1, 8)
