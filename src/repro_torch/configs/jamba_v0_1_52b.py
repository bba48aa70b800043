"""Jamba-v0.1 52B [arXiv:2403.19887]. 32L, d_model=4096, 32 heads (GQA kv=8),
d_ff=14336, vocab=65536, MoE 16 experts top-2. Superblock of 8 layers:
attention at position 4, Mamba elsewhere (1:7), MoE on odd positions.
Hybrid recurrent state -> long_500k runs."""
from repro_torch.configs.base import (
    AttentionConfig,
    BlockSpec,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.configs.catalog import reduce_for_smoke

_PATTERN = tuple(
    BlockSpec(
        mixer="attn" if i == 4 else "mamba",
        mlp="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    max_seq_len=262144,
    attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    pattern=_PATTERN,
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(
    CONFIG,
    num_layers=2,
    pattern=(BlockSpec("mamba", "moe"), BlockSpec("attn", "dense")),
)
