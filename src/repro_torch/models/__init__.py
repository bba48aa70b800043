from repro_torch.models.model import (
    IGNORE_INDEX,
    Transformer,
    cast_params,
    cross_entropy,
    embed,
    forward_train,
    head_logits,
    init_model,
    loss_fn,
    param_count,
    param_leaves,
    shared_leaves,
)
from repro_torch.models.transformer import stage_apply, template_block

__all__ = [
    "IGNORE_INDEX",
    "Transformer",
    "cast_params",
    "cross_entropy",
    "embed",
    "forward_train",
    "head_logits",
    "init_model",
    "loss_fn",
    "param_count",
    "param_leaves",
    "shared_leaves",
    "stage_apply",
    "template_block",
]
