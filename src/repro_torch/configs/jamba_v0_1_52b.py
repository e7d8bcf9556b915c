"""jamba-v0.1-52b — hybrid Mamba+attention MoE  [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Mamba:attention 7:1 interleave (one attention layer per 8, at offset 4 within the
period, per the Jamba paper), MoE every other layer.  Attention layers use a
windowed KV cache for the long-context decode shape (the Mamba layers carry the
long-range state).
"""

from repro_torch.configs.base import ModelConfig, register


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="arXiv:2403.19887",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        moe=True,
        num_experts=16,
        experts_per_token=2,
        num_shared_experts=0,
        moe_d_ff=14336,
        moe_period=2,
        moe_offset=1,
        attn_period=8,
        attn_offset=4,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        sliding_window=32768,
        subquadratic=True,
    )
