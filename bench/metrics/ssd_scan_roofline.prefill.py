"""The SSD scan kernels' least time over their device time in a prefill."""

from bench.harness.readers import ssd_scan_roofline as read  # noqa: F401
