"""The RMSNorm kernel's least time over its device time in a prefill."""

from bench.harness.readers import rmsnorm_roofline as read  # noqa: F401
