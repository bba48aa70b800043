"""The paper's ~3B model (Appendix I): d_model=2688, 32 blocks."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="paper_3b",
    family="dense",
    source="paper Appendix I (Fig. 20)",
    num_layers=32,
    d_model=2688,
    d_ff=10752,
    vocab_size=50304,
    max_seq_len=512,
    attention=AttentionConfig(num_heads=42, num_kv_heads=42, head_dim=64),
    pattern=(BlockSpec("attn", "dense"),),
    norm="layernorm",
    mlp_act="gelu",
    learnable_pos_emb=True,
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2)
