"""The flash kernels' least time over their device time in a training step:
each forward, and each backward (a dQ and a dK/dV launch) held to the work
it needs once."""

from bench.harness.readers import flash_roofline as read  # noqa: F401
