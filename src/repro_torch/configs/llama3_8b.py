"""llama3-8b — dense LM, GQA, 128k vocab  [arXiv:2407.21783; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""

from repro_torch.configs.base import ModelConfig, register


@register("llama3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        source="arXiv:2407.21783",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=5e5,
    )
