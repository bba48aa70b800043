"""Configuration dataclasses for the model and the optimizer.

Port of ``repro/configs/base.py``, cut to what the model configs use:
grouped-query and MLA attention (``AttentionConfig``), the recurrent
mixers (``SSMConfig``: Mamba, mLSTM and sLSTM blocks), the MoE MLP
(``MoEConfig``), the modality frontends (a projected prefix of frontend
embeddings, several codebooks), the stacked layers and their remat policy,
the chunked cross-entropy, and the dry run's four input shapes
(``InputShape``, ``INPUT_SHAPES``).
Defaults are the reference's; dtype properties return torch dtypes. Both
of the reference's precision policies exist: ``f32`` and ``bf16``
(``bf16_compute``, the SPMD backend's). The reference's ``seq_sharded``
acts on a tensor-parallel ``model`` axis, which the port does not have.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class AttentionConfig:
    """Attention mixer configuration (GQA or MLA)."""

    kind: str = "gqa"  # "gqa" | "mla"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window size (None = full causal)
    rope_theta: float = 10_000.0
    # MLA-only fields (DeepSeek-V2 style latent attention)
    q_lora_rank: int = 0  # 0 = no query compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def q_dim(self) -> int:
        if self.kind == "mla":
            return self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.num_heads * self.head_dim

    @property
    def kv_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent mixer configuration: the Mamba mixer
    (``d_state``, ``d_conv``, ``expand``, ``dt_rank``) and the mLSTM and
    sLSTM mixers (``num_heads``, ``proj_factor``)."""

    kind: str = "mamba"  # "mamba" | "mlstm" | "slstm"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    num_heads: int = 4  # for m/sLSTM
    proj_factor: float = 2.0  # mLSTM up-projection factor


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts MLP configuration."""

    num_experts: int = 8
    top_k: int = 2
    num_shared: int = 0  # DeepSeek-style always-on shared experts
    d_ff_expert: int = 0  # 0 -> use model d_ff
    aux_loss_coef: float = 0.01
    router_jitter: float = 0.0
    capacity_factor: float = 1.25
    # GShard routing-group size: the dispatch one-hots are per group
    group_size: int = 4096


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
    moe: Optional[MoEConfig] = None
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    mlp_act: str = "swiglu"  # "swiglu" | "gelu"
    tie_embeddings: bool = False
    learnable_pos_emb: bool = False
    # modality frontend stub: the batch carries precomputed embeddings
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_tokens: int = 0  # prefix embedding tokens before the text
    frontend_dim: int = 0  # width of those embeddings, projected into d_model
    num_codebooks: int = 1  # >1: a summed embedding and a head per codebook
    # True: one leaf per pattern position, stacked over the superblocks on a
    # leading axis, each superblock run under activation checkpointing.
    # False: one parameter subtree per layer (per-layer delays in the sim).
    scan_layers: bool = True
    # accepted for the reference's configs and without effect: it unrolls
    # the reference's superblock scan, and the port's superblocks run in a
    # Python loop, which has nothing to unroll
    scan_unroll: bool = False
    logits_fp32: bool = True
    # activation-checkpoint policy of the stacked layers: "full" recomputes
    # everything, "dots" saves the (non-batched) matrix products
    remat_policy: str = "full"
    # chunked cross-entropy: the head and CE over sequence chunks of this
    # length, so the (B, S, V) logits are never formed. 0 = off
    loss_chunk: int = 0
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

    def supports_long_context(self) -> bool:
        """True when the 500k decode shape is admissible: recurrent or hybrid
        families, or attention that is windowed everywhere."""
        if self.family in ("ssm", "hybrid"):
            return True
        return all(spec.mixer != "attn" or self.attention.window is not None
                   for spec in self.pattern)


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
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
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
