"""CPU tests of the benchmark (``test_bench_*.py``).  They need no card: a
run is driven on the CPU at a tiny size, where the port's kernels run as
their plain versions."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def tiny_cell(name: str) -> dict:
    """The cell ``name`` with its widths, depth, vocabulary, batch and
    lengths cut to a CPU test's size and computed in float32 (bf16 rounding
    at a tiny width is not the cell's); its limits and everything else as
    committed.  The family's stack keeps two layers after the leading dense
    ones (``first_k_dense``, kept); an MoE configuration keeps 8 experts, 2
    a token, of width 32, and at most one shared expert."""
    from bench.harness import cells

    c = cells.load_cell(name)
    m = c["config"]["model"]
    m.update(dtype="float32", param_dtype="float32")
    if m["family"] == "ssm":
        m.update(num_layers=2, d_model=64, vocab_size=100, ssm_state=16, ssm_head_dim=16,
                 ssm_chunk=8)
    else:
        m.update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                 vocab_size=100)
    if m.get("num_experts"):
        m.update(num_experts=8, experts_per_token=2, moe_d_ff=32,
                 num_shared_experts=min(m.get("num_shared_experts", 0), 1))
    m["num_layers"] += m.get("first_k_dense", 0)
    t = c["traffic"]
    t["batch"] = 2
    if t["kind"] == "train":
        t["seq_len"] = 32
    else:
        t.update(prompt_len=32, keep_among=3, sample_requests=4)
    return c
