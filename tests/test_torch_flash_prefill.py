"""A prefill's attention through the flash kernels.

``attention(..., return_cache=True)`` with ``use_kernels="cuda"`` runs the
flash path (the kernels' plain versions on the CPU), and returns the same
cache as the chunked plain path (``use_kernels="off"``): the projected k and
v.  A head dim or dtype the kernels do not take reaches them and is refused
there, as in training.  Lengths the tiles do not divide run padded at the
end.  A prefill's cache then feeds a decode that matches the full forward.
``chip_smoke.py`` (phase 7) holds the kernels themselves to the plain path on
the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.launch.serve import prefill_cache
from repro_torch.launch.steps import make_decode_step
from repro_torch.model import attention as attn
from repro_torch.model import lm
from repro_torch.model.layers import init_params
from test_torch_serving import _full_logits


def _cfg(mode="cuda", head_dim=64, dtype="float32"):
    """Grouped-query attention: 6 query heads over 2 kv heads (groups of 3)."""
    return dataclasses.replace(get_config("smollm-135m").reduced(), num_heads=6,
                               num_kv_heads=2, head_dim=head_dim, dtype=dtype,
                               param_dtype=dtype, use_kernels=mode)


def _layer(cfg, S, B=2, seed=0):
    params = init_params(attn.attn_defs(cfg), seed, default_dtype=cfg.param_dtype,
                         device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(B, S, cfg.d_model, generator=g).to(getattr(torch, cfg.dtype))
    return params, x


@pytest.fixture
def flash_calls(monkeypatch):
    """Every ``flash_attention`` call the attention layer makes, by the
    query's shape."""
    calls = []
    run = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return run(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("S", [64, 128, 37, 200])  # multiples, then padded lengths
def test_prefill_flash_matches_plain_and_returns_the_same_cache(S, flash_calls):
    cfg = _cfg()
    params, x = _layer(cfg, S)
    pos = torch.arange(S)
    with torch.no_grad():
        y, (k, v) = attn.attention(params, x, cfg, pos, return_cache=True)
        y_off, (k_off, v_off) = attn.attention(params, x, _cfg("off"), pos, return_cache=True)
    assert flash_calls == [(2, S, 6, 64)]
    assert y.shape == y_off.shape == (2, S, cfg.d_model)
    torch.testing.assert_close(y, y_off, atol=1e-5, rtol=1e-5)
    assert k.shape == (2, S, 2, 64)
    assert torch.equal(k, k_off) and torch.equal(v, v_off)


def test_padding_is_exact_for_the_real_rows():
    """A causal attention of 200 rows, padded to 256 on the CPU, gives the
    first 200 rows of the same attention run over a longer sequence."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 256, n, 64, generator=g) for n in (6, 2, 2))
    assert ops._causal_pad(q, 200, 200, True, 128, 128) == 56
    assert ops._causal_pad(q, 37, 37, True, 128, 128) == 0
    assert ops._causal_pad(q, 200, 200, False, 128, 128) == 0
    cut = ops.flash_attention(q[:, :200], k[:, :200], v[:, :200], causal=True)
    whole = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(cut, whole[:, :200], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", ["window", "decode", "plain"])
def test_prefill_takes_the_chunked_path_where_flash_does_not_apply(case, flash_calls):
    cfg = _cfg(mode="off" if case == "plain" else "cuda")
    S = 1 if case == "decode" else 64
    params, x = _layer(cfg, S)
    with torch.no_grad():
        if case == "decode":
            cache = (torch.zeros(2, 16, 2, 64), torch.zeros(2, 16, 2, 64))
            _, (k, _) = attn.attention(params, x, cfg, torch.tensor([5]), cache=cache,
                                       write_pos=torch.tensor(5))
            assert k is cache[0]
        else:
            window = 16 if case == "window" else 0
            _, (k, _) = attn.attention(params, x, cfg, torch.arange(S), window=window,
                                       return_cache=True)
            assert k.shape == (2, S, 2, cfg.head_dim)
    assert flash_calls == []


@pytest.mark.parametrize("case", ["head_dim", "dtype"])
def test_prefill_sends_what_the_kernels_refuse_to_them(case, flash_calls, monkeypatch):
    """A head dim outside ``kernel.HEAD_DIMS`` or a float16 prefill takes
    the flash route, and the card's forward refuses it in
    ``kernel.check_inputs``, as it refuses such a training step: there is no
    chunked fallback.  The card's entry point is called on CPU tensors,
    whose checks come before any launch."""
    cfg = _cfg(head_dim=48 if case == "head_dim" else 64,
               dtype="float16" if case == "dtype" else "float32")
    params, x = _layer(cfg, 64)

    def card_fwd(q, k, v, *, causal, scale, block_k):
        return kernel.flash_fwd_cuda(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(ops, "flash_fwd", card_fwd)
    want = "head dim 48" if case == "head_dim" else "bfloat16 or all float32"
    with torch.no_grad(), pytest.raises(ValueError, match=want):
        attn.attention(params, x, cfg, torch.arange(64), return_cache=True)
    assert flash_calls == [(2, 64, 6, cfg.head_dim)]


@pytest.mark.parametrize("S0", [37, 136])  # the second pads to 256 rows on the CPU
def test_decode_from_the_flash_prefill_cache_matches_the_forward(S0, flash_calls):
    cfg = get_config("smollm-135m").reduced()  # bfloat16, use_kernels="cuda"
    params = lm.init_model(cfg, 1, device="cpu")
    S = S0 + 6
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(3, cfg.vocab_size, (2, S)).astype(np.int32))
    ref = _full_logits(params, dataclasses.replace(cfg, use_kernels="off"), tokens)
    logits, cache = prefill_cache(params, cfg, tokens[:, :S0], S)
    assert flash_calls == [(2, S0, cfg.num_heads, cfg.head_dim)] * cfg.num_layers
    np.testing.assert_allclose(logits.numpy(), ref[:, S0 - 1].numpy(), atol=2e-2, rtol=2e-2)
    step = make_decode_step(cfg)
    for i in range(S0, S):
        logits, cache = step(params, cache, tokens[:, i], i)
        np.testing.assert_allclose(logits.numpy(), ref[:, i].numpy(), atol=3e-2, rtol=3e-2,
                                   err_msg=f"pos {i}")
