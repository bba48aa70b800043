"""xLSTM 1.3B [arXiv:2405.04517]. 48 blocks, d_model=2048, 4 heads, d_ff=0
(blocks integrate their own FF), vocab=50304, xLSTM[7:1]: superblock of
8 = 7 mLSTM + 1 sLSTM. Pure recurrent state -> O(1) per-token decode
memory."""
from repro_torch.configs.base import BlockSpec, ModelConfig, SSMConfig
from repro_torch.configs.catalog import reduce_for_smoke

_PATTERN = tuple(
    BlockSpec(mixer="slstm" if i == 3 else "mlstm", mlp="none") for i in range(8)
)

CONFIG = ModelConfig(
    name="xlstm_1_3b",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=48,
    d_model=2048,
    d_ff=0,
    vocab_size=50304,
    max_seq_len=524288,
    ssm=SSMConfig(kind="mlstm", num_heads=4, proj_factor=2.0),
    pattern=_PATTERN,
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE_CONFIG = reduce_for_smoke(
    CONFIG,
    num_layers=2,
    pattern=(BlockSpec("mlstm", "none"), BlockSpec("slstm", "none")),
)
