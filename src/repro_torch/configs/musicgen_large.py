"""MusicGen-large [arXiv:2306.05284]. 48L decoder over EnCodec tokens:
d_model=2048, 32 heads (MHA), d_ff=8192, 4 codebooks x vocab=2048 summed at
the input and predicted by 4 heads. The EnCodec conv codec is stubbed:
inputs are token ids in the 4 codebooks. Full attention."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="musicgen_large",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    max_seq_len=32768,
    attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=64),
    pattern=(BlockSpec("attn", "dense"),),
    norm="layernorm",
    mlp_act="gelu",
    num_codebooks=4,
    frontend="audio",
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(
    CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2, vocab_size=128
)
