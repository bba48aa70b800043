"""LLaVA-NeXT-34B language backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf,
34B variant]. 60L, d_model=7168, 56 heads (GQA kv=8), d_ff=20480,
vocab=64000. AnyRes vision tiling is stubbed: the batch carries
precomputed patch embeddings (frontend_dim=1152, SigLIP-patch-sized), and
the model owns only the projector into d_model. Full attention."""
from repro_torch.configs.base import AttentionConfig, BlockSpec, ModelConfig
from repro_torch.configs.catalog import reduce_for_smoke

CONFIG = ModelConfig(
    name="llava_next_34b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34B cfg)",
    num_layers=60,
    d_model=7168,
    d_ff=20480,
    vocab_size=64000,
    max_seq_len=32768,
    attention=AttentionConfig(num_heads=56, num_kv_heads=8, head_dim=128),
    pattern=(BlockSpec("attn", "dense"),),
    frontend="vision",
    frontend_tokens=2880,  # anyres: base 576 + 4 tiles x 576
    frontend_dim=1152,
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(CONFIG, num_layers=2, pattern=(BlockSpec("attn", "dense"),) * 2)
