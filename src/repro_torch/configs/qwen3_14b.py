"""qwen3-14b — dense LM, qk-norm + GQA  [hf:Qwen/Qwen3-14B; hf].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen3-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        source="hf:Qwen/Qwen3-14B",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
    )
