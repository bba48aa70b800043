from repro_torch.checkpoint.ckpt import (
    load_checkpoint,
    save_checkpoint,
    save_sharded_checkpoint,
    snapshot_sharded,
    write_sharded_checkpoint,
)
from repro_torch.checkpoint.convert import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
    stack_layers,
    stacked_from_numpy,
    stacked_to_numpy,
    unstack_layers,
)

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "save_sharded_checkpoint",
    "snapshot_sharded",
    "write_sharded_checkpoint",
    "opt_state_from_numpy",
    "opt_state_to_numpy",
    "params_from_numpy",
    "params_to_numpy",
    "stack_layers",
    "stacked_from_numpy",
    "stacked_to_numpy",
    "unstack_layers",
]
