"""starcoder2-7b — dense code LM, GQA + RoPE  [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""

from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        source="arXiv:2402.19173",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        rope_theta=1e5,
    )
