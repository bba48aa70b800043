"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b]. 24L, d_model=2048,
32 heads (MHA: kv=32), d_ff=5632, vocab=100352, LayerNorm. Full attention ->
long_500k skipped."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="stablelm_1_6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=24,
    d_model=2048,
    d_ff=5632,
    vocab_size=100352,
    max_seq_len=4096,
    attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=64),
    pattern=(BlockSpec("attn", "dense"),),
    norm="layernorm",
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2)
