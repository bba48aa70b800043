"""Mixtral 8x22B [arXiv:2401.04088]. 56L, d_model=6144, 48 heads (GQA kv=8),
d_ff=16384, vocab=32768, MoE 8 experts top-2, sliding-window attention
(window 4096)."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig, MoEConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="mixtral_8x22b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    d_ff=16384,
    vocab_size=32768,
    max_seq_len=65536,
    attention=AttentionConfig(num_heads=48, num_kv_heads=8, head_dim=128, window=4096),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    pattern=(BlockSpec("attn", "moe"),),
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "moe"),) * 2)
