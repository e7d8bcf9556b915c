"""Device ms a training step in cuBLAS float32 GEMMs: the LM head's backward
products where no other float32 product runs."""

from bench.harness.readers import f32_gemm_ms as read  # noqa: F401
