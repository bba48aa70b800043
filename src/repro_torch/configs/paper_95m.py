"""The paper's ~95M nanoGPT model (Appendix D.2): d_model=384, 6 heads,
32 blocks, seq 512, learnable positional embedding, untied LM head."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="paper_95m",
    family="dense",
    source="paper Appendix D.2 (nanoGPT)",
    num_layers=32,
    d_model=384,
    d_ff=1536,
    vocab_size=50304,
    max_seq_len=512,
    attention=AttentionConfig(num_heads=6, num_kv_heads=6, head_dim=64),
    pattern=(BlockSpec("attn", "dense"),),
    norm="layernorm",
    mlp_act="gelu",
    learnable_pos_emb=True,
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2)
