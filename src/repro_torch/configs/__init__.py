from repro_torch.configs.base import (
    PRECISION_POLICIES,
    AttentionConfig,
    BlockSpec,
    ModelConfig,
    OptimizerConfig,
    PrecisionPolicy,
)
from repro_torch.configs.catalog import PAPER_IDS, get_config, reduce_for_smoke

__all__ = [
    "PRECISION_POLICIES",
    "AttentionConfig",
    "BlockSpec",
    "ModelConfig",
    "OptimizerConfig",
    "PrecisionPolicy",
    "PAPER_IDS",
    "get_config",
    "reduce_for_smoke",
]
