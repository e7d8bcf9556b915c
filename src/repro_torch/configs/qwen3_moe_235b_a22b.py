"""qwen3-moe-235b-a22b — large sparse MoE  [hf:Qwen/Qwen3-30B-A3B family; hf].

94L d_model=4096 64H (GQA kv=4) moe_d_ff=1536 vocab=151936, 128 experts top-8,
qk-norm, head_dim=128.
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        source="hf:Qwen/Qwen3-235B-A22B",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        qk_norm=True,
        moe=True,
        num_experts=128,
        experts_per_token=8,
        num_shared_experts=0,
        moe_d_ff=1536,
        moe_period=1,
        rope_theta=1e6,
    )
