"""AdamW, its schedule and its state (``optim/adamw.py``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig, adamw_update, cosine_lr, global_norm, init_opt_state,
    opt_state_defs,
)
