from repro_torch.models.model import (
    IGNORE_INDEX,
    Transformer,
    cross_entropy,
    forward_train,
    init_model,
    loss_fn,
    param_count,
    param_leaves,
)

__all__ = [
    "IGNORE_INDEX",
    "Transformer",
    "cross_entropy",
    "forward_train",
    "init_model",
    "loss_fn",
    "param_count",
    "param_leaves",
]
