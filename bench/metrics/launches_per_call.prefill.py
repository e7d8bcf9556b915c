"""Kernels the device ran in the traced window per prefill request batch."""

from bench.harness.readers import launches_per_call as read  # noqa: F401
