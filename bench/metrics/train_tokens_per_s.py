"""Training tokens of every step completed in the window over the window's
seconds (host clock, closed on a synchronize)."""

from bench.harness.readers import tokens_per_s as read  # noqa: F401
