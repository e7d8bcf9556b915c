from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)
