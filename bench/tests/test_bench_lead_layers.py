"""Leading dense layers (``first_k_dense``) in the reference frame and the
yardstick: the frame with k leading layers is the k = 0 network with their
leaves moved to the front of the stack, to the bit in loss and gradients;
the leaves split by their own group's count; the work is counted by layer
kind; and the RMSNorm launches listed are those the port makes in a
training step under every remat policy."""

import dataclasses
import importlib.util
import sys
import types

import pytest
import torch

from bench.harness import program
from bench.harness.train import _loss_and_grads
from bench.harness.weights import flatten, leaf_tensors, make_weights
from bench.reference import lm
from bench.reference.precision import Precision
from bench.tests import tiny_cell
from bench.work import dense as dense_work
from bench.work import kernels, model as work

LEAD, STACK = "layers/lead/", "layers/pos0/"


def toy(k: int) -> dict:
    """The dense tiny cell at 3 layers, the first k of them leading."""
    m = tiny_cell("smollm-135m.train")["config"]["model"]
    return dict(m, num_layers=3, first_k_dense=k)


def moved(flat: dict) -> dict:
    """The k = 1 leaves as the k = 0 network's: ``layers/lead/*[0]`` in row
    0 of the stack."""
    out = {p: t for p, t in flat.items() if not p.startswith(LEAD)}
    for p, t in flat.items():
        if p.startswith(LEAD):
            out[STACK + p[len(LEAD):]] = torch.cat([t, flat[STACK + p[len(LEAD):]]])
    return out


@pytest.mark.parametrize("rows", [1, 3], ids=["rows_1", "rows_all"])
def test_a_leading_layer_is_the_stacks_first_layer_to_the_bit(rows):
    one, zero = toy(1), toy(0)
    params = make_weights(one, 5, torch.device("cpu"))
    flat0 = moved(params)
    assert {p: tuple(t.shape) for p, t in flat0.items()} == \
        {p: s for p, s, *_ in lm.param_spec(zero)}
    g = torch.Generator().manual_seed(9)
    ids = torch.randint(0, one["vocab_size"], (3, 17), generator=g)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    prec = Precision("float32")
    grads1, loss1 = _loss_and_grads(params, one, batch, prec, rows)
    grads0, loss0 = _loss_and_grads(flat0, zero, batch, prec, rows)
    assert loss1 == loss0
    for p, g0 in moved(grads1).items():
        assert torch.equal(g0, grads0[p]), p


def test_leaf_tensors_names_and_counts_both_groups():
    model = toy(1)
    leaves = leaf_tensors(make_weights(model, 5, torch.device("cpu")), model)
    lead = [n for n in leaves if n.startswith(LEAD)]
    stack = [n for n in leaves if n.startswith(STACK)]
    assert len(lead) == 9 and all(n.endswith("[0]") for n in lead)
    assert len(stack) == 18 and sum(n.endswith("[1]") for n in stack) == 9
    assert "layers/lead/mixer/wq[0]" in leaves and "layers/pos0/ffn/w_down[1]" in leaves
    assert set(leaves) - set(lead) - set(stack) == {"embed/tok", "final_norm/scale"}
    with pytest.raises(ValueError, match="layers stacked"):
        leaf_tensors({"layers/lead/norm_mixer/scale": torch.ones(2, 4)}, model)


def test_the_reference_prefill_refuses_leading_layers():
    model = toy(1)
    params = make_weights(model, 5, torch.device("cpu"))
    with pytest.raises(ValueError, match="first_k_dense"):
        lm.prefill(params, model, torch.zeros(1, 4, dtype=torch.int32), Precision("float32"))


HYBRID = dict(family="ssm", first_k_dense=1, num_layers=3, d_model=8, num_heads=2,
              num_kv_heads=1, head_dim=4, d_ff=16, ssm_expand=2, ssm_state=4, ssm_head_dim=4,
              ssm_chunk=5, vocab_size=10, dtype="bfloat16")


def test_forward_flops_count_each_kind_of_layer_by_hand():
    B, S = 3, 5
    dense = 2 * B * S * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16) \
        + 4 * (B * S * (S + 1) // 2) * 2 * 4
    ssm = 2 * B * S * (8 * (2 * 16 + 2 * 4 + 4) + 16 * 8) \
        + kernels.ssd_scan(B, S, 4, 4, 4, 5, "bfloat16")[0]
    assert work.forward_flops(HYBRID, B, S, 0) == dense + 2 * ssm
    assert work.prefill_flops(HYBRID, B, S) == dense + 2 * ssm + 2 * B * 8 * 10


@pytest.mark.parametrize("remat", ["none", "block", "save_dispatch"])
def test_rmsnorm_launches_list_each_kind_of_layer_by_hand(remat):
    forward = [8, 8] + [8, 16] * 2 + [8]  # the leading layer's, the SSM blocks', the final
    rerun = [8, 8] + [8, 16] * 2
    model = dict(HYBRID, remat=remat)
    assert [w for _, w, _ in work.rmsnorm_launches(model, 16, False)] == forward
    want = forward + (rerun if remat != "none" else [])
    assert [w for _, w, _ in work.rmsnorm_launches(model, 16, True)] == want


def port_rmsnorm_calls(cfg, batch: dict) -> list:
    """(rows, width) of every ``rms_norm`` call of one training step of the
    port with ``cfg``."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.model import layers
    from repro_torch.model import lm as port_lm
    from repro_torch.optim import OptConfig, init_opt_state

    plain, calls = layers.rms_norm, []

    def counted(x, scale, eps, kernels):
        calls.append((x.numel() // x.shape[-1], x.shape[-1]))
        return plain(x, scale, eps, kernels)

    users = [m for name, m in list(sys.modules.items())
             if name.startswith("repro_torch.") and getattr(m, "rms_norm", None) is plain]
    for m in users:
        m.rms_norm = counted
    try:
        params = program.params_tree(flatten(port_lm.init_model(cfg, 0, device="cpu")), True)
        opt = OptConfig()
        state = init_opt_state(params, opt)
        make_train_step(cfg, opt)(params, state, batch)
    finally:
        for m in users:
            m.rms_norm = plain
    return calls


@pytest.mark.parametrize("remat", ["block", "save_dispatch", "none"])
def test_rmsnorm_launches_match_the_ports_calls_in_a_training_step(remat, monkeypatch):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), use_kernels="off",
                              remat=remat)
    B, S = 2, 16
    ids = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator().manual_seed(3))
    calls = port_rmsnorm_calls(cfg, {"tokens": ids[:, :-1], "labels": ids[:, 1:]})
    model = dataclasses.asdict(cfg)
    if importlib.util.find_spec("bench.work.moe") is None:
        # an MoE block normalises before its mixer and its FFN, at d_model,
        # as the dense block does
        stand_in = types.ModuleType("bench.work.moe")
        stand_in.norm_widths = dense_work.norm_widths
        monkeypatch.setitem(sys.modules, "bench.work.moe", stand_in)
    listed = [(r, w) for r, w, _ in work.rmsnorm_launches(model, B * S, True)]
    assert sorted(calls) == sorted(listed)
    assert len(calls) == (2 if remat == "none" else 4) * model["num_layers"] + 1
