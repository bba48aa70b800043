from repro_torch.configs.base import (
    INPUT_SHAPES,
    PRECISION_POLICIES,
    AttentionConfig,
    BlockSpec,
    InputShape,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    PrecisionPolicy,
    SSMConfig,
)
from repro_torch.configs.catalog import (
    ARCH_IDS,
    PAPER_IDS,
    get_config,
    reduce_for_smoke,
    shapes_for,
)

__all__ = [
    "INPUT_SHAPES",
    "PRECISION_POLICIES",
    "AttentionConfig",
    "BlockSpec",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "OptimizerConfig",
    "PrecisionPolicy",
    "SSMConfig",
    "ARCH_IDS",
    "PAPER_IDS",
    "get_config",
    "reduce_for_smoke",
    "shapes_for",
]
