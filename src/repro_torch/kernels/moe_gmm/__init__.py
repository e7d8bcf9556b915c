from repro_torch.kernels.moe_gmm.ops import grouped_matmul  # noqa: F401
