"""Kernels the device ran in the traced window per training step."""

from bench.harness.readers import launches_per_call as read  # noqa: F401
