"""95th percentile of every request batch's time from submission to its first tokens on the host."""

from bench.harness.readers import ttft_p95_ms as read  # noqa: F401
