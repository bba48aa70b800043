from repro_torch.sharding.rules import (
    cache_pspecs,
    generic_activation_pspec,
    opt_state_pspecs,
    param_pspec,
    params_pspecs,
    shard_shape,
    sharded_bytes,
    tokens_pspec,
)

__all__ = [
    "cache_pspecs",
    "generic_activation_pspec",
    "opt_state_pspecs",
    "param_pspec",
    "params_pspecs",
    "shard_shape",
    "sharded_bytes",
    "tokens_pspec",
]
