from repro_torch.kernels.quant.ops import dequantize_int8, quantize_int8  # noqa: F401
