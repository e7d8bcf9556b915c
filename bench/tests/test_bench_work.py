"""The yardstick's counts (``bench/work``) against counts by hand at small
shapes."""

import json

import pytest

from bench.tests import ROOT
from bench.work import BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, HBM_BYTES_PER_S, kernels, model


def test_flash_counts_causal_pairs():
    B, S, H, KV, hd = 2, 4, 3, 1, 8
    pairs = B * H * (1 + 2 + 3 + 4)  # query i attends to keys 0..i
    w = kernels.flash(B, S, H, KV, hd, "bfloat16")
    assert w["forward"][0] == 2 * (2 * pairs * hd)       # QK^T and PV
    # QK^T, dO.V^T, dV = P^T.dO, dQ = dS.K, dK = dS^T.Q, each once
    assert w["backward"][0] == 5 * (2 * pairs * hd)
    q, kv, rows = B * H * S * hd * 2, B * KV * S * hd * 2, B * H * S * 4
    assert w["forward"][1] == 2 * q + 2 * kv + rows       # q, k, v in; o, lse out
    assert w["backward"][1] == 4 * q + 4 * kv + rows      # q, o, dO, k, v, lse in; dq, dk, dv out
    # non-causal: every pair
    assert kernels.flash(B, S, H, KV, hd, "float32", causal=False)["forward"][0] \
        == 4 * B * H * S * S * hd


def test_flash_bound_at_the_training_shape():
    # bf16 forward at (8, 2048, 9, 3, 64): operations bound, 39.1 us; the
    # backward two and a half times that
    w = kernels.flash(8, 2048, 9, 3, 64, "bfloat16")
    f, b, s = w["forward"]
    assert s == pytest.approx(f / BF16_FLOPS_PER_S) and s == pytest.approx(39.10e-6, rel=1e-3)
    assert w["backward"][2] == pytest.approx(2.5 * s)


def test_ssd_counts_by_hand():
    B, S, nh, P, N, chunk = 1, 8, 2, 3, 5, 4
    pairs = 4 * 5 // 2
    chunks = 2
    by_hand = (B * chunks * 2 * pairs * N                       # C.B^T, causal half, per chunk
               + B * nh * chunks * 2 * pairs * P                # W.x, causal half
               + B * nh * chunks * 2 * chunk * P * N            # C.state
               + B * nh * chunks * 2 * chunk * P * N)           # the state update
    f, b, _ = kernels.ssd_scan(B, S, nh, P, N, chunk, "float32")
    assert f == by_hand
    assert b == (2 * B * nh * S * P * 4 + 2 * B * nh * S * 4 + 2 * B * S * N * 4
                 + B * nh * P * N * 4)


def test_ssd_bound_at_the_path_shape():
    # the kernel table's bf16 path bound: 35.37 us, by bytes
    f, b, s = kernels.ssd_scan(8, 2048, 24, 64, 128, 256, "bfloat16")
    assert s == pytest.approx(b / HBM_BYTES_PER_S) and s == pytest.approx(35.37e-6, rel=1e-3)


def test_rmsnorm_counts_and_launches():
    f, b, s = kernels.rmsnorm(16384, 576, "bfloat16")
    assert (f, b) == (4 * 16384 * 576, 2 * 16384 * 576 * 2 + 4 * 576)
    assert s == pytest.approx(11.27e-6, rel=1e-3) and s > f / FP32_FLOPS_PER_S
    smol = json.loads((ROOT / "bench/configs/smollm-135m.json").read_text())["model"]
    mamba = json.loads((ROOT / "bench/configs/mamba2-130m.json").read_text())["model"]
    # launch counts a call the kernels' counters showed on the card
    assert len(model.rmsnorm_launches(dict(smol, remat="block"), 16, True)) == 121
    assert len(model.rmsnorm_launches(dict(smol, remat="none"), 16, True)) == 61
    assert len(model.rmsnorm_launches(smol, 16, False)) == 61
    assert len(model.rmsnorm_launches(mamba, 16, False)) == 49
    widths = sorted({d for _, d, _ in model.rmsnorm_launches(mamba, 16, True)})
    assert widths == [768, 1536]


def test_model_flops_by_hand():
    dense = dict(family="dense", num_layers=2, d_model=8, num_heads=2, num_kv_heads=1,
                 head_dim=4, d_ff=16, vocab_size=10, dtype="bfloat16")
    B, S = 3, 5
    weights = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    attn = 4 * (B * S * (S + 1) // 2) * 2 * 4
    fwd = 2 * (2 * B * S * weights + attn)
    assert model.forward_flops(dense, B, S, 0) == fwd
    assert model.train_flops(dense, B, S) == 3 * (fwd + 2 * B * S * 8 * 10)
    assert model.prefill_flops(dense, B, S) == fwd + 2 * B * 8 * 10
    ssm = dict(family="ssm", num_layers=1, d_model=8, ssm_expand=2, ssm_state=4,
               ssm_head_dim=4, ssm_chunk=5, vocab_size=10, dtype="bfloat16")
    di, nh = 16, 4
    w = 8 * (2 * di + 2 * 4 + nh) + di * 8
    scan = kernels.ssd_scan(B, S, nh, 4, 4, 5, "bfloat16")[0]
    assert model.prefill_flops(ssm, B, S) == 2 * B * S * w + scan + 2 * B * 8 * 10
