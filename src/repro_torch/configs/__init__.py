"""Architecture registry: one module per assigned architecture."""

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPE_CELLS,
    BlockKind,
    ModelConfig,
    ShapeCell,
    get_config,
    list_archs,
    register,
)

_ARCH_MODULES = [
    "jamba_v0_1_52b",
    "deepseek_moe_16b",
    "qwen3_moe_235b_a22b",
    "starcoder2_7b",
    "smollm_135m",
    "llama3_8b",
    "qwen3_14b",
    "internvl2_2b",
    "mamba2_130m",
    "musicgen_large",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _loaded = True
