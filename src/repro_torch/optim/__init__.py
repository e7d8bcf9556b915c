from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_at,
)
