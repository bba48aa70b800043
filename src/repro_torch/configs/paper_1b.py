"""The paper's ~1B model (Appendix D.2): d_model=1728, 27 heads, 24 blocks."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="paper_1b",
    family="dense",
    source="paper Appendix D.2",
    num_layers=24,
    d_model=1728,
    d_ff=6912,
    vocab_size=50304,
    max_seq_len=512,
    attention=AttentionConfig(num_heads=27, num_kv_heads=27, head_dim=64),
    pattern=(BlockSpec("attn", "dense"),),
    norm="layernorm",
    mlp_act="gelu",
    learnable_pos_emb=True,
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2)
