"""The port's attention products against the JAX package's, on bf16 inputs.

The decode reads the (B, S, kv, hd) cache as it lies: one product over every
(kv head, key slot) pair of a batch row, of which the diagonal blocks are
kept, and p spread block-diagonally for ``P.V``.  The chunked prefill lays
the repeated K/V out head-major.  Both are held here to the reference's
``einsum(..., preferred_element_type=float32)`` on the same bf16 inputs, at
several GQA groupings.  On the CPU ``_bmm_f32`` casts the operands to
float32; on the card it is ``torch.bmm(..., out_dtype=torch.float32)``, the
same products.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.model import attention as JA
from repro_torch.model import attention as A


def _bf16(rng, *shape):
    """The same bf16 values as a torch tensor and a JAX array."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    return x, jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B, S, kv, G, hd",
                         [(2, 48, 3, 3, 64), (1, 40, 4, 1, 32), (3, 16, 1, 4, 16)])
@pytest.mark.parametrize("plain", [False, True])
def test_cache_products_match_reference_einsum(B, S, kv, G, hd, plain):
    rng = np.random.default_rng(B * 100 + S)
    (q_g, jq), (ck, jk), (cv, jv) = (_bf16(rng, B, kv, G, hd), _bf16(rng, B, S, kv, hd),
                                     _bf16(rng, B, S, kv, hd))
    want = jnp.einsum("bkgd,bskd->bkgs", jq, jk, preferred_element_type=jnp.float32)
    got = A._cache_scores(q_g, ck, plain)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    p = torch.softmax(got, dim=-1).to(torch.bfloat16)
    jp = jnp.asarray(p.float().numpy(), dtype=jnp.bfloat16)
    want = jnp.einsum("bkgs,bskd->bkgd", jp, jv, preferred_element_type=jnp.float32)
    got = A._cache_mix(p, cv, plain)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("H, kv", [(6, 6), (6, 2)])
def test_head_major_block_matches_reference_block(window, H, kv):
    rng = np.random.default_rng(window * 10 + kv)
    B, Q, S, hd, G = 2, 8, 24, 32, H // kv
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, B, Q, H, hd), _bf16(rng, B, S, kv, hd),
                                 _bf16(rng, B, S, kv, hd))
    rows, cols = 8 + torch.arange(Q), torch.arange(S)
    want = JA._attn_block(jq, jnp.repeat(jk, G, axis=2), jnp.repeat(jv, G, axis=2),
                          jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()), window, 0.25)
    k_full = torch.repeat_interleave(k.transpose(1, 2), G, dim=1).contiguous()
    v_full = torch.repeat_interleave(v.transpose(1, 2), G, dim=1).contiguous()
    got = A._attn_block(q, k_full, v_full, rows, cols, window, 0.25, plain=False)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    # both round p and the output to bf16: one bf16 step of the output apart at most
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1.6e-2)
