"""deepseek-moe-16b — fine-grained MoE  [arXiv:2401.06066; hf].

28L d_model=2048 16H (GQA kv=16, i.e. MHA) d_ff=1408 (per routed expert),
vocab=102400, 64 routed experts top-6 + 2 shared experts.
"""

from repro_torch.configs.base import ModelConfig, register


@register("deepseek-moe-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        source="arXiv:2401.06066",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        moe=True,
        num_experts=64,
        experts_per_token=6,
        num_shared_experts=2,
        moe_d_ff=1408,
        moe_period=1,
    )
