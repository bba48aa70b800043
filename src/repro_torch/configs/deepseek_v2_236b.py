"""DeepSeek-V2 236B [arXiv:2405.04434]. 60L, d_model=5120, 128 heads, MLA with
kv_lora_rank=512 (q_lora_rank=1536, nope=128, rope=64, v=128), per-expert
d_ff=1536, vocab=102400, MoE: 2 shared + 160 routed top-6. The MLA compressed
cache (512+64 per token) is what a decode step reads."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig, MoEConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="deepseek_v2_236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    d_ff=1536,
    vocab_size=102400,
    max_seq_len=131072,
    attention=AttentionConfig(
        kind="mla",
        num_heads=128,
        num_kv_heads=128,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared=2, d_ff_expert=1536),
    pattern=(BlockSpec("attn", "moe"),),
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "moe"),) * 2)
