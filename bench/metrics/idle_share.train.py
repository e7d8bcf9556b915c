"""Share of the traced training window in which the device ran nothing."""

from bench.harness.readers import idle_share as read  # noqa: F401
