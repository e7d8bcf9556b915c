"""smollm-135m — llama-architecture small model  [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""

from repro_torch.configs.base import ModelConfig, register


@register("smollm-135m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        source="hf:HuggingFaceTB/SmolLM-135M",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
    )
