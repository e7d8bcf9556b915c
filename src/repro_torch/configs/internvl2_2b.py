"""internvl2-2b — VLM backbone (InternLM2-1.8B)  [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT vision
frontend is a STUB per the assignment: ``input_specs()`` provides precomputed
patch embeddings which are concatenated with text-token embeddings.
"""

from repro_torch.configs.base import ModelConfig, register


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        source="arXiv:2404.16821",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        frontend="vision",
    )
