"""``bench/work``'s forward model FLOPs of one prefill, held to the matrix
FLOPs the port's own counter (``launch/hlo_analysis.py::StepCounter``)
counts for the same call on the reduced configurations.  The test imports
the port; the benchmark does not, so a change to the counter leaves the
yardstick as it is.

Terms the two count differently, named here:

* the padded vocabulary: the port's head multiplies ``padded_vocab``
  columns, the yardstick counts the ``vocab_size`` the model has;
* the causal halves: the plain path (``use_kernels="off"``, which the
  counter traces) multiplies every (query, key) pair of the attention and
  every (q, k) pair of an SSD chunk and masks the upper half away; the
  yardstick counts the causal pairs only;
* elementwise work (norms, activations, softmax, the causal conv): counted
  by neither.
"""

import dataclasses

import pytest
import torch

from bench.work import kernels, model as work

ARCHS = ("smollm-135m", "mamba2-130m")


def counted(arch: str, B: int, S: int):
    from repro_torch.configs import get_config
    from repro_torch.launch.hlo_analysis import StepCounter
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.model import lm

    cfg = dataclasses.replace(get_config(arch).reduced(), use_kernels="off")
    params = lm.init_model(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32)
    by_op = {}

    class ByOp(StepCounter):
        def _count(self, func, args, kwargs, out):
            before = self.stats.flops
            super()._count(func, args, kwargs, out)
            key = str(func._overloadpacket)
            by_op[key] = by_op.get(key, 0.0) + self.stats.flops - before

    with ByOp():
        make_prefill_step(cfg)(params, {"tokens": tokens})
    return cfg, by_op


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matmul_flops_match_the_counter(arch):
    B, S = 2, 32
    cfg, by_op = counted(arch, B, S)
    m = dataclasses.asdict(cfg)
    L, d = m["num_layers"], m["d_model"]
    # the projections and the head (aten.mm): the yardstick's forward less
    # its mixer, plus the head's padded columns
    projections = work.prefill_flops(m, B, S) - L * work.mixer_flops(m, B, S)
    padding = 2 * B * d * (cfg.padded_vocab - cfg.vocab_size)
    assert by_op.get("aten.mm", 0.0) == projections + padding
    # the mixer's products (aten.bmm): causal pairs against full squares
    if m["family"] == "ssm":
        Q, N, P = m["ssm_chunk"], m["ssm_state"], m["ssm_head_dim"]
        nh = m["ssm_expand"] * d // P
        pairs, chunks = Q * (Q + 1) // 2, S // Q
        yard = kernels.ssd_scan(B, S, nh, P, N, Q, m["dtype"])[0]
        assert L * work.mixer_flops(m, B, S) == L * yard
        squares = yard + (B * chunks * 2 * N + B * nh * chunks * 2 * P) * (Q * Q - pairs)
    else:
        pairs = B * S * (S + 1) // 2
        assert work.mixer_flops(m, B, S) == 4 * pairs * m["num_heads"] * m["head_dim"]
        squares = 4 * B * S * S * m["num_heads"] * m["head_dim"]
    assert by_op.get("aten.bmm", 0.0) == L * squares
    assert set(by_op) - {"aten.mm", "aten.bmm"} <= {k for k, v in by_op.items() if v == 0}
