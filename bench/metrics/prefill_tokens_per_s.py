"""Prompt tokens of every request batch completed in the window over the
window's seconds (host clock)."""

from bench.harness.readers import tokens_per_s as read  # noqa: F401
