"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family]. 28L, d_model=1024, 16 heads
(GQA kv=8), head_dim=128 (q-dim 2048 != d_model), d_ff=3072, vocab=151936,
qk-norm. Full attention -> long_500k skipped."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen3_0_6b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (0.6B cfg)",
    num_layers=28,
    d_model=1024,
    d_ff=3072,
    vocab_size=151936,
    max_seq_len=32768,
    attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=128, qk_norm=True),
    pattern=(BlockSpec("attn", "dense"),),
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2)
