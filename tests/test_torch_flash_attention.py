"""The port's flash-attention module against the JAX package.

The same numpy-seeded q, k, v (and dO) go through the port's plain version
(what ``flash_attention`` runs for CPU tensors) and the JAX Pallas kernels in
interpret mode, at the shapes of ``tests/test_kernels.py``: the forward
within 3e-5 in float32 and 2e-2 in bfloat16, the gradients of the autograd
``Function`` against the JAX custom VJP within 2e-4 (the reference's own
tolerances).  The CUDA kernels run only on the card (``chip_smoke.py`` holds
them to these plain versions there); here their wrapper's input checks and
launch counters are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro_torch.kernels.flash_attention import flash_attention, kernel, ref


def _inputs(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))
    ]


@pytest.mark.parametrize(
    "B,S,H,KV,hd,causal,dtype",
    [
        (2, 256, 4, 2, 64, True, "float32"),
        (1, 512, 8, 8, 128, True, "float32"),
        (2, 128, 6, 3, 64, False, "float32"),
        (1, 256, 4, 1, 64, True, "bfloat16"),
    ],
)
def test_forward_matches_pallas_interpret(B, S, H, KV, hd, causal, dtype):
    q, k, v, _ = _inputs(B, S, H, KV, hd)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jflash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                  causal=causal, interpret=True)
    got = flash_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=causal)
    assert got.dtype == td and got.shape == (B, S, H, hd)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 256, 4, 2, 64), (2, 128, 6, 3, 32)])
def test_backward_matches_custom_vjp(B, S, H, KV, hd):
    q, k, v, do = _inputs(B, S, H, KV, hd, seed=1)

    def f(q, k, v):
        return jnp.sum(jflash(q, k, v, causal=True, interpret=True) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4, err_msg=f"d{name}"
        )


def test_plain_versions_match_attention_ref():
    """The kernels' plain versions against the full-softmax oracle and its
    autograd, at a GQA shape (float32)."""
    B, S, H, KV, hd = 2, 192, 6, 2, 32
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B, S, H, KV, hd, seed=2))
    qf = q.transpose(1, 2).reshape(B * H, S, hd).requires_grad_(True)
    kf = k.transpose(1, 2).reshape(B * KV, S, hd).requires_grad_(True)
    vf = v.transpose(1, 2).reshape(B * KV, S, hd).requires_grad_(True)
    dof = do.transpose(1, 2).reshape(B * H, S, hd)
    o_ref = ref.attention_ref(qf, kf, vf, causal=True)
    grads_ref = torch.autograd.grad(o_ref, (qf, kf, vf), dof)
    with torch.no_grad():
        o, lse = ref.flash_fwd_ref(qf, kf, vf, causal=True, block_k=64)
        delta = ref.delta_of(o, dof)
        dq = ref.flash_bwd_dq_ref(qf, kf, vf, dof, lse, delta, block_q=64)
        dk, dv = ref.flash_bwd_dkv_ref(qf, kf, vf, dof, lse, delta, block_q=64)
        s = torch.matmul(qf, kf.repeat_interleave(3, 0).transpose(1, 2)) / hd ** 0.5
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    np.testing.assert_allclose(o.numpy(), o_ref.detach().numpy(), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=3e-5, rtol=3e-5)
    for g, w in zip((dq, dk, dv), grads_ref):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=2e-4)


def _folded(BH=4, BKV=2, S=128, hd=64, dtype=torch.float32):
    return (torch.zeros(BH, S, hd, dtype=dtype), torch.zeros(BKV, S, hd, dtype=dtype),
            torch.zeros(BKV, S, hd, dtype=dtype))


@pytest.mark.parametrize(
    "case,match",
    [
        ("cpu", "CUDA tensors"),
        ("head_dim", "head dim"),
        ("seq", "multiples of 64"),
        ("dtype", "bfloat16 or all float32"),
        ("mixed_dtype", "bfloat16 or all float32"),
        ("contiguous", "contiguous"),
        ("groups", "do not group"),
        ("rank", r"\(BH, S, hd\)"),
        ("seq_k", "multiples of 64"),
        ("head_dim_8", "head dim"),
        ("kv_shape", "k .* / v"),
        ("aligned", "16-byte boundary"),
    ],
)
def test_wrapper_input_checks_raise_without_nvcc(case, match):
    q, k, v = _folded()
    if case == "head_dim":
        q, k, v = _folded(hd=48)
    elif case == "seq":
        q, k, v = _folded(S=96)
    elif case == "dtype":
        q, k, v = _folded(dtype=torch.float16)
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "contiguous":
        q = torch.zeros(4, 64, 128).transpose(1, 2)
    elif case == "groups":
        q = torch.zeros(3, 128, 64)
    elif case == "rank":
        q = q[None]
    elif case == "seq_k":
        q, k, v = q, k[:, :96].contiguous(), v[:, :96].contiguous()
    elif case == "head_dim_8":
        q, k, v = _folded(hd=8)
    elif case == "kv_shape":
        v = v[:, :64].contiguous()
    elif case == "aligned":
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(ValueError, match=match):
        kernel.flash_fwd_cuda(q, k, v)


@pytest.mark.parametrize(
    "BH,BKV,Sq,Sk,hd,causal",
    [
        (4, 2, 192, 192, 16, True),  # S % 128 == 64: half of the last 128-row block
        (4, 2, 192, 192, 32, True),
        (6, 3, 128, 128, 64, True),
        (8, 2, 64, 64, 128, True),
        (4, 2, 192, 320, 64, False),  # Sq != Sk
        (4, 4, 320, 192, 128, True),
        (72, 24, 2048, 2048, 64, False),
    ],
)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_accept_every_shape_the_kernels_take(BH, BKV, Sq, Sk, hd, causal, dtype):
    q = torch.zeros(BH, Sq, hd, dtype=dtype)
    k, v = torch.zeros(BKV, Sk, hd, dtype=dtype), torch.zeros(BKV, Sk, hd, dtype=dtype)
    lse = torch.zeros(BH, Sq)
    assert kernel.check_inputs(q, k, v, q) == (BH, BKV, Sq, Sk, hd)
    # past every shape check, only the device is refused here
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_fwd_cuda(q, k, v, causal=causal)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_bwd_dq_cuda(q, k, v, q, lse, lse, causal=causal)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_bwd_dkv_cuda(q, k, v, q, lse, lse, causal=causal)


def test_backward_wrappers_check_rows_and_device():
    q, k, v = _folded()
    lse = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_bwd_dq_cuda(q, k, v, q.clone(), lse, lse.clone())
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_bwd_dkv_cuda(q, k, v, q.clone(), lse, lse.clone())
    with pytest.raises(ValueError, match="shaped like q"):
        kernel.flash_bwd_dq_cuda(q, k, v, q[:, :64].clone(), lse, lse.clone())
    # contiguous rows that start 4 bytes past a 16-byte boundary
    shifted = torch.zeros(lse.numel() + 1)[1:].view(lse.shape)
    for wrapper in (kernel.flash_bwd_dq_cuda, kernel.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="lse must start on a 16-byte boundary"):
            wrapper(q, k, v, q.clone(), shifted, lse.clone())
        with pytest.raises(ValueError, match="delta must start on a 16-byte boundary"):
            wrapper(q, k, v, q.clone(), lse, shifted)


def test_launch_counters_stay_zero_on_cpu():
    before = (kernel.FWD_LAUNCHES, kernel.DQ_LAUNCHES, kernel.DKV_LAUNCHES)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 128, 4, 2, 32, seed=3))
    q.requires_grad_(True)
    out = flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out, q, do)
    assert (kernel.FWD_LAUNCHES, kernel.DQ_LAUNCHES, kernel.DKV_LAUNCHES) == before == (0, 0, 0)
