"""Configuration dataclasses for the model and the optimizer.

Port of ``repro/configs/base.py``, cut to what the dense attention models
(the paper's nanoGPT family and the dense public architectures) and the
xLSTM family (``SSMConfig``, mLSTM and sLSTM blocks) use.
Defaults are the reference's; dtype properties return torch dtypes. Both
of the reference's precision policies exist: ``f32`` and ``bf16``
(``bf16_compute``, the SPMD backend's).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class AttentionConfig:
    """Grouped-query attention mixer configuration."""

    kind: str = "gqa"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window size (None = full causal)
    rope_theta: float = 10_000.0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent mixer configuration. The port runs the mLSTM
    and sLSTM mixers (``num_heads``, ``proj_factor``); the Mamba fields are
    kept so that configs convert field for field."""

    kind: str = "mamba"  # "mamba" | "mlstm" | "slstm"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    num_heads: int = 4  # for m/sLSTM
    proj_factor: float = 2.0  # mLSTM up-projection factor


@dataclass(frozen=True)
class BlockSpec:
    """One layer inside the repeating superblock pattern."""

    mixer: str = "attn"
    mlp: str = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    source: str = ""
    num_layers: int = 2
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 4096
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    ssm: Optional[SSMConfig] = None
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    mlp_act: str = "swiglu"  # "swiglu" | "gelu"
    tie_embeddings: bool = False
    learnable_pos_emb: bool = False
    # the port keeps one parameter subtree per layer; stacked layers belong
    # to the SPMD engine
    scan_layers: bool = True
    logits_fp32: bool = True
    loss_chunk: int = 0  # chunked cross-entropy is not ported yet
    dtype: str = "float32"
    param_dtype: str = "float32"
    use_kernels: bool = False

    @property
    def num_superblocks(self) -> int:
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"pattern length {len(self.pattern)} must divide "
                f"num_layers {self.num_layers}"
            )
        return self.num_layers // len(self.pattern)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PrecisionPolicy:
    """Compute/state dtype selection applied on top of a ModelConfig.

    The policy only selects dtypes; the model and the schedules own every
    cast (``models.model.cast_params``: float32 masters to compute-dtype
    copies at use; float32 norms, softmax and cross-entropy; ``logits_fp32``),
    and the optimizer only ever sees float32 state. ``bf16_compute`` is
    bfloat16 activations and products with float32 masters, optimizer state
    and loss reductions, which ``analysis.dtype.BF16_COMPUTE_POLICY`` checks
    on a traced step.
    """

    name: str = "f32"
    dtype: str = "float32"  # activation / product compute dtype
    param_dtype: str = "float32"  # parameter masters (and optimizer state)
    logits_fp32: bool = True  # keep the vocab head in float32

    def apply(self, cfg: ModelConfig) -> ModelConfig:
        return cfg.replace(
            dtype=self.dtype, param_dtype=self.param_dtype,
            logits_fp32=self.logits_fp32,
        )


PRECISION_POLICIES = {
    "f32": PrecisionPolicy(),
    "bf16": PrecisionPolicy(name="bf16_compute", dtype="bfloat16"),
}


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "basis_rotation"
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_frac: float = 0.012
    schedule: str = "cosine"  # "cosine" | "constant"
    total_steps: int = 1000
    rotation_source: str = "2nd"  # "1st" | "2nd"
    rotation_geometry: str = "bilateral"  # "unilateral" | "bilateral"
    rotation_freq: int = 10
    stage_aware: bool = False
    stage_aware_reversed: bool = False
    dc_lambda: float = 0.1
    nesterov_beta: float = 0.99
