from repro_torch.pipeline.delay import delayed_optimizer, stage_delayed_optimizer
from repro_torch.pipeline.partition import (
    delay_tree,
    layer_to_stage,
    leaf_delays,
    leaf_stages,
    stage_context_for_stacked,
    stage_context_for_tree,
)
from repro_torch.pipeline.simulate import (
    make_sim_train_step,
    make_two_version_loss,
    predict_weights,
    run_sim_training,
    stale_forward_params,
)

__all__ = [
    "delayed_optimizer",
    "stage_delayed_optimizer",
    "delay_tree",
    "layer_to_stage",
    "leaf_delays",
    "leaf_stages",
    "stage_context_for_stacked",
    "stage_context_for_tree",
    "make_sim_train_step",
    "make_two_version_loss",
    "predict_weights",
    "run_sim_training",
    "stale_forward_params",
]
