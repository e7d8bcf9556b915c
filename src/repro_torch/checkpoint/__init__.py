from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    load_flat,
    restore,
    save,
)
