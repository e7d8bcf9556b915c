"""musicgen-large — decoder-only LM over EnCodec tokens  [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048.  The EnCodec audio
frontend is a STUB per the assignment: ``input_specs()`` provides precomputed
frame embeddings (the interleaved-codebook embedding sum).
"""

from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        source="arXiv:2306.05284",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        frontend="audio",
    )
