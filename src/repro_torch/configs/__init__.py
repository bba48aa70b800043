from repro_torch.configs.base import (
    PRECISION_POLICIES,
    AttentionConfig,
    BlockSpec,
    ModelConfig,
    OptimizerConfig,
    PrecisionPolicy,
    SSMConfig,
)
from repro_torch.configs.catalog import ARCH_IDS, PAPER_IDS, get_config, reduce_for_smoke

__all__ = [
    "PRECISION_POLICIES",
    "AttentionConfig",
    "BlockSpec",
    "ModelConfig",
    "OptimizerConfig",
    "PrecisionPolicy",
    "SSMConfig",
    "ARCH_IDS",
    "PAPER_IDS",
    "get_config",
    "reduce_for_smoke",
]
