"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]. 24L, d_model=1024, 16 heads
(MHA kv=16), head_dim=64, d_ff=2816, vocab=151936, QKV bias. Full attention
-> long_500k skipped."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen1_5_0_5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    d_ff=2816,
    vocab_size=151936,
    max_seq_len=32768,
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=64, qkv_bias=True),
    pattern=(BlockSpec("attn", "dense"),),
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2)
