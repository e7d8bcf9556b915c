"""bf16 drift of mamba2-130m at its published widths, the port against the JAX package.

The serving checks on the card hold bf16 logits to a limit above the reduced
configs' 3e-2 (``chip_smoke.py``, ``BF16_LOGITS_TOL``).  These tests show, on
the CPU, that the drift behind that limit is bf16 rounding that the JAX
reference shows as well, and that a fault shows far above it.  The widths are mamba2-130m's (d 768, d_inner 1536, 24 heads of 64,
state 128, chunk 256, vocab 50280); the depth is cut from 24 layers to 8 to
keep the CPU's time and memory small.  The weights are the JAX model's from a
seed, carried across by ``params_from_numpy``; the prompt is numpy-seeded.

* Decode against the full forward (``tests/test_lm_consistency.py``'s
  contract): the JAX model's bf16 decode drifts past 3e-2 too; the port's
  drift is within a factor 1.5 of the JAX model's; a control whose prefill
  hands decode zeroed SSM states drifts at least 3 times as far.
* The kernel path (on the CPU, the SSD scan's plain version, float32 inside)
  against ``use_kernels="off"`` (the reference's ``ssd_chunked``, which rounds
  its chunk weights to bf16), logits at every position: the gap is no larger
  than the one between the JAX model and the port's plain path, two
  implementations of the same bf16 math; a control that loses the state
  carried across the chunk boundary is at least 3 times as far off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.model import lm as jlm
from repro_torch.configs import get_config
from repro_torch.launch.serve import prefill_cache
from repro_torch.model import lm
from repro_torch.model.convert import params_from_numpy

LAYERS = 8


@pytest.fixture(scope="module")
def full_width():
    jcfg = dataclasses.replace(jget_config("mamba2-130m"), num_layers=LAYERS)
    tcfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=LAYERS)
    assert jcfg.dtype == "bfloat16" and tcfg.use_kernels == "cuda"
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                                tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _jax_logits(jparams, jcfg, tokens):
    hidden, _, _ = jlm.forward_hidden(jparams, jcfg, tokens)
    w = jparams["embed"]["tok"].T
    logits = jnp.einsum("bsd,dv->bsv", hidden.astype(jnp.float32), w.astype(jnp.float32))
    return logits[..., :jcfg.vocab_size]


def _port_logits(tparams, tcfg, tokens):
    with torch.inference_mode():
        hidden, _, _ = lm.forward_hidden(tparams, tcfg, tokens)
        logits = torch.matmul(hidden.float(), lm._head_w(tparams).float())
    return logits[..., :tcfg.vocab_size].numpy()


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _jax_decode_drift(jparams, jcfg, tokens, S0):
    S, V = tokens.shape[1], jcfg.vocab_size
    ref = np.asarray(jax.jit(lambda p, t: _jax_logits(p, jcfg, t))(jparams, tokens))
    _, small = jlm.prefill(jparams, jcfg, tokens=tokens[:, :S0])
    cache = jax.tree.map(
        lambda b, s: jnp.pad(s.astype(b.dtype), [(0, x - y) for x, y in zip(b.shape, s.shape)]),
        jlm.init_cache(jcfg, tokens.shape[0], S), small)
    step = jax.jit(lambda p, c, t, i: jlm.decode_step(p, jcfg, c, t, i))
    errs = []
    for i in range(S0, S):
        logits, cache = step(jparams, cache, tokens[:, i], jnp.int32(i))
        errs.append(_err(np.asarray(logits)[:, :V], ref[:, i]))
    return max(errs)


def _port_decode_drift(tparams, tcfg, tokens, S0, lose_state=False):
    S, V = tokens.shape[1], tcfg.vocab_size
    ref = _port_logits(tparams, tcfg, tokens)
    with torch.inference_mode():
        _, cache = prefill_cache(tparams, tcfg, tokens[:, :S0], S)
        if lose_state:
            for leaves in cache.values():
                leaves["state"].zero_()
        errs = []
        for i in range(S0, S):
            logits, cache = lm.decode_step(tparams, tcfg, cache, tokens[:, i], i)
            errs.append(_err(logits[:, :V].numpy(), ref[:, i]))
    return max(errs)


def test_bf16_decode_drift_matches_reference(full_width):
    jcfg, tcfg, jparams, tparams = full_width
    B, S0, S = 1, 224, 256  # one chunk: prefill and forward at most 256 tokens
    tokens = np.random.default_rng(1).integers(3, jcfg.vocab_size, (B, S)).astype(np.int32)
    jax_drift = _jax_decode_drift(jparams, jcfg, jnp.asarray(tokens), S0)
    port_drift = _port_decode_drift(tparams, tcfg, torch.from_numpy(tokens), S0)
    control = _port_decode_drift(tparams, tcfg, torch.from_numpy(tokens), S0, lose_state=True)
    readings = f"jax {jax_drift:.4g}, port {port_drift:.4g}, control {control:.4g}"
    assert jax_drift > 3e-2, readings  # the reference too leaves the reduced tolerance
    assert port_drift <= 1.5 * jax_drift and jax_drift <= 1.5 * port_drift, readings
    assert control >= 3 * port_drift, readings


def test_bf16_kernel_path_gap_matches_reference(full_width):
    jcfg, tcfg, jparams, tparams = full_width
    off = dataclasses.replace(tcfg, use_kernels="off")
    Q, S = tcfg.ssm_chunk, 2 * tcfg.ssm_chunk  # two chunks: a state carried across
    tokens = np.random.default_rng(2).integers(3, jcfg.vocab_size, (1, S)).astype(np.int32)
    t = torch.from_numpy(tokens)
    want = _port_logits(tparams, off, t)
    gap = _err(_port_logits(tparams, tcfg, t), want)
    reference_gap = _err(jax.jit(lambda p, x: _jax_logits(p, jcfg, x))(jparams, tokens), want)
    control = _err(np.concatenate([_port_logits(tparams, tcfg, t[:, i:i + Q])
                                   for i in range(0, S, Q)], 1), want)
    readings = f"kernel path {gap:.4g}, reference {reference_gap:.4g}, control {control:.4g}"
    assert gap <= reference_gap, readings
    assert control >= 3 * gap, readings
