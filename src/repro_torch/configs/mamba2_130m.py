"""mamba2-130m — attention-free SSD  [arXiv:2405.21060; unverified].

24L d_model=768, d_inner=1536 (expand 2), head_dim=64 (24 SSM heads),
ssm_state=128, vocab=50280, no FFN (d_ff=0).
"""

from repro_torch.configs.base import ModelConfig, register


@register("mamba2-130m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        source="arXiv:2405.21060",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        attn_period=0,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        tie_embeddings=True,
        subquadratic=True,
    )
