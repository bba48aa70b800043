"""Phi-4-mini 3.8B [arXiv:2412.08905]. 32L, d_model=3072, 24 heads (GQA kv=8),
d_ff=8192, vocab=200064, RoPE + SwiGLU + GQA. Full attention -> long_500k
skipped by default; `SWA_CONFIG` is the beyond-paper sliding-window variant
(window 8192) that unlocks the 500k decode shape for a dense arch."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="phi4_mini_3_8b",
    family="dense",
    source="arXiv:2412.08905",
    num_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=200064,
    max_seq_len=131072,
    attention=AttentionConfig(num_heads=24, num_kv_heads=8, head_dim=128),
    pattern=(BlockSpec("attn", "dense"),),
    dtype="bfloat16",
    param_dtype="float32",
)

SWA_CONFIG = CONFIG.replace(
    name="phi4_mini_3_8b_swa",
    attention=AttentionConfig(num_heads=24, num_kv_heads=8, head_dim=128, window=8192),
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2)
