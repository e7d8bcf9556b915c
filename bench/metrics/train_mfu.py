"""The training step's model FLOPs over the measured (untraced) window and
the bf16 peak (work/model.py)."""

from bench.harness.readers import mfu as read  # noqa: F401
