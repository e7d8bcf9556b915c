from repro_torch.kernels.rmsnorm.ops import RMSNorm, rmsnorm  # noqa: F401
