"""The yardstick's arithmetic: the card's published peaks, each kernel's
operations and bytes at a shape, and a model's FLOPs per step.

Everything here is computed from shapes alone and imports nothing of the
program, so a later change to the program cannot move it.
"""

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
BF16_FLOPS_PER_S = 989e12   # bf16 / fp16 tensor cores
FP32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """Least seconds for ``flops`` at ``peak`` and ``nbytes`` at the HBM rate,
    whichever is larger."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
