from repro_torch.checkpoint.convert import (
    params_from_numpy,
    params_to_numpy,
    stacked_from_numpy,
    stacked_to_numpy,
)

__all__ = ["params_from_numpy", "params_to_numpy", "stacked_from_numpy", "stacked_to_numpy"]
