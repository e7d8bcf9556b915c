"""The flash forward kernel's least time over its device time in a prefill:
one forward a layer, no backward."""

from bench.harness.readers import flash_roofline as read  # noqa: F401
