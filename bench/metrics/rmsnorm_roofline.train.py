"""The RMSNorm kernel's least time over its device time in a training step."""

from bench.harness.readers import rmsnorm_roofline as read  # noqa: F401
