"""Share of the traced prefill window in which the device ran nothing."""

from bench.harness.readers import idle_share as read  # noqa: F401
