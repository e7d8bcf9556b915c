"""Seconds from process start to the first timed call: imports, kernel loads,
weights from the seed, the warm-up and check calls."""

from bench.harness.readers import setup_s as read  # noqa: F401
