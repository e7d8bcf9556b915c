"""Model/architecture configuration.

Every assigned architecture is described by a :class:`ModelConfig`.  The config is a
frozen dataclass so it can be hashed into jit caches, and carries enough structure for

  * the layer library (``repro_torch.model``) to build the exact network,
  * the partitioner (``repro_torch.core``) to enumerate per-actor sharding strategies,
  * the dry-run (``repro_torch.launch.dryrun``) to build ``ShapeDtypeStruct`` inputs.

The full-size configs are only ever *lowered* (no allocation); smoke tests use
``reduced()`` which shrinks every scale knob while preserving the family structure
(hybrid interleave, MoE routing, GQA ratios, qk-norm, frontends, ...).

Copy of ``repro/configs/base.py``.  Edit: the execution-policy field
``use_pallas`` ("off" | "interpret" | "tpu") is ``use_kernels`` here
("off" | "cuda", default "cuda").
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, replace

from typing import Callable, Dict, List, Tuple


# ---------------------------------------------------------------------------
# Block layout descriptors
# ---------------------------------------------------------------------------

# Mixer kinds: how a block mixes information along the sequence.
MIXER_ATTN = "attn"
MIXER_SSM = "ssm"

# FFN kinds.
FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclass(frozen=True)
class BlockKind:
    """Structure of one layer: a sequence mixer plus an optional FFN."""

    mixer: str  # MIXER_ATTN | MIXER_SSM
    ffn: str  # FFN_DENSE | FFN_MOE | FFN_NONE

    @property
    def tag(self) -> str:
        return f"{self.mixer}-{self.ffn}"


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    source: str = ""  # citation string

    # -- transformer backbone ----------------------------------------------
    num_layers: int = 2
    d_model: int = 64
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 32
    d_ff: int = 128
    vocab_size: int = 256
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False

    # -- MoE -----------------------------------------------------------------
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden width
    moe_period: int = 1  # a layer is MoE iff moe and (layer % moe_period == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # -- SSM / hybrid ---------------------------------------------------------
    attn_period: int = 1  # hybrid: a layer is attention iff (layer % attn_period ==
    attn_offset: int = 0  # attn_offset); pure-ssm uses attn_period=0 (never).
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # -- attention windows ------------------------------------------------------
    sliding_window: int = 0  # 0 = full causal; >0 = window size (used by hybrid
    #                           archs for the long-context decode shape)

    # -- modality frontend (stub) ----------------------------------------------
    frontend: str = "none"  # none | vision | audio ; stubs feed embeddings directly

    # -- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # -- execution policy (perf levers, see EXPERIMENTS.md §Perf) -----------------
    use_kernels: str = "cuda"  # "off" (plain chunked torch attention) |
    #   "cuda" (the hand-written CUDA kernels on CUDA tensors; their plain
    #   PyTorch versions on CPU tensors — the CPU tests)
    remat: str = "block"  # "block" (checkpoint every block) | "none"
    accum_steps: int = 0  # gradient-accumulation microbatches (0 = auto policy)
    batch_chunks: int = 1  # >1: scan batch chunks *inside* each block
    #   (weight-stationary accumulation: per-layer FSDP weight gathers happen
    #    once per pass instead of once per microbatch; replaces train-step
    #    gradient accumulation)

    # -- applicability ------------------------------------------------------------
    subquadratic: bool = False  # True for ssm / hybrid: may run long_500k

    # ------------------------------------------------------------------ helpers --
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so it shards over the model axis."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_attn(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def block_kind(self, layer: int) -> BlockKind:
        """Which (mixer, ffn) structure layer ``layer`` has."""
        if self.ssm_state and self.attn_period == 0:
            mixer = MIXER_SSM
        elif self.ssm_state:
            mixer = (
                MIXER_ATTN
                if layer % self.attn_period == self.attn_offset
                else MIXER_SSM
            )
        else:
            mixer = MIXER_ATTN
        if self.family == "ssm" and self.d_ff == 0:
            ffn = FFN_NONE
        elif self.moe and layer % self.moe_period == self.moe_offset:
            ffn = FFN_MOE
        else:
            ffn = FFN_DENSE
        return BlockKind(mixer, ffn)

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (scan unit)."""
        p = 1
        if self.ssm_state and self.attn_period > 0:
            p = self._lcm(p, self.attn_period)
        if self.moe and self.moe_period > 1:
            p = self._lcm(p, self.moe_period)
        return p

    @staticmethod
    def _lcm(a: int, b: int) -> int:
        return a * b // math.gcd(a, b)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.period == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"period={self.period}"
        )
        return self.num_layers // self.period

    def pattern(self) -> List[BlockKind]:
        """The repeating per-period layer pattern."""
        return [self.block_kind(i) for i in range(self.period)]

    # -- parameter counting (used for 6ND model-FLOPs and cost model) -------------
    def param_counts(self) -> Dict[str, int]:
        """Analytic parameter counts by component (total and active)."""
        d = self.d_model
        counts: Dict[str, int] = {}
        counts["embed"] = self.vocab_size * d
        counts["head"] = 0 if self.tie_embeddings else d * self.vocab_size
        total = active = 0
        for layer in range(self.num_layers):
            kind = self.block_kind(layer)
            n = 0
            a = 0
            if kind.mixer == MIXER_ATTN:
                n += d * self.d_attn  # wq
                n += 2 * d * self.num_kv_heads * self.head_dim  # wk, wv
                n += self.d_attn * d  # wo
                a = n
            else:  # ssm
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
                n_in = d * (2 * di + 2 * ds + nh)  # in_proj -> x, z, B, C, dt
                n_conv = (di + 2 * ds) * self.ssm_conv_width
                n_out = di * d
                n += n_in + n_conv + n_out + nh  # + A_log
                a = n
            if kind.ffn == FFN_DENSE:
                f = 3 * d * self.d_ff  # SwiGLU: gate, up, down
                n += f
                a += f
            elif kind.ffn == FFN_MOE:
                per_expert = 3 * d * self.moe_d_ff
                n += self.num_experts * per_expert
                n += self.num_shared_experts * per_expert
                n += d * self.num_experts  # router
                a += (self.experts_per_token + self.num_shared_experts) * per_expert
                a += d * self.num_experts
            total += n
            active += a
        counts["blocks_total"] = total
        counts["blocks_active"] = active
        counts["total"] = counts["embed"] + counts["head"] + total
        counts["active"] = counts["embed"] + counts["head"] + active
        return counts

    # -- shape-cell applicability ---------------------------------------------------
    def cell_supported(self, cell: ShapeCell) -> Tuple[bool, str]:
        if cell.name == "long_500k" and not self.subquadratic:
            return False, (
                "pure full-attention arch: 512k dense-KV decode has no "
                "sub-quadratic structure (DESIGN.md §Arch-applicability)"
            )
        return True, ""

    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        # keep the GQA structure: MHA stays MHA, grouped stays grouped (kv>=2
        # so head-grouping bugs cannot hide behind a collapsed kv=1)
        if self.num_heads == 0:
            kv_r = 0
        elif self.num_kv_heads == self.num_heads:
            kv_r = 4
        else:
            kv_r = 2 if self.num_kv_heads > 1 else 1
        kw = dict(
            num_layers=min(self.num_layers, 2 * self.period),
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=kv_r,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=128,
        )
        if self.moe:
            kw.update(num_experts=min(self.num_experts, 8),
                      experts_per_token=min(self.experts_per_token, 2),
                      moe_d_ff=32)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
        if self.sliding_window:
            kw.update(sliding_window=64)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        # import the per-arch modules lazily
        from repro_torch import configs as _pkg  # noqa: F401

        _pkg.load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> List[str]:
    from repro_torch import configs as _pkg

    _pkg.load_all()
    return sorted(_REGISTRY)
