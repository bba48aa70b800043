"""Catalog of the ported architectures (port of ``repro/configs/catalog.py``).

Each module exports ``CONFIG`` (the published configuration) and
``SMOKE_CONFIG`` (the same family reduced by ``reduce_for_smoke``);
``phi4_mini_3_8b`` also exports ``SWA_CONFIG``, the sliding-window variant
that ``get_config`` returns for an id ending in ``_swa``. The dense public
architectures, the xLSTM family (``xlstm_1_3b``: mLSTM and sLSTM blocks in a
superblock of 8, without MLPs) and the paper's models are ported; every
other id of the reference's catalog raises ``NotImplementedError`` naming
what it needs.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

ARCH_IDS: List[str] = ["stablelm_1_6b", "qwen3_0_6b", "qwen1_5_0_5b", "phi4_mini_3_8b",
                       "xlstm_1_3b"]

PAPER_IDS = ["paper_95m", "paper_1b", "paper_3b"]

# the reference's other catalog ids, with what their port needs first
UNPORTED: Dict[str, str] = {
    "llava_next_34b": "the vision frontend (frontend_proj and prefix embeddings)",
    "mixtral_8x22b": "MoE blocks (models/moe.py)",
    "jamba_v0_1_52b": "Mamba SSM and MoE blocks (models/mamba.py, models/moe.py)",
    "deepseek_v2_236b": "MLA attention and MoE blocks (models/attention.py::mla_*, "
                        "models/moe.py)",
    "musicgen_large": "the audio frontend and multi-codebook embedding and head",
}

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS + PAPER_IDS + list(UNPORTED)}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = _ALIAS.get(name, name).replace("-", "_")
    variant = None
    if mod_name.endswith("_swa"):  # the sliding-window variants
        mod_name, variant = mod_name[: -len("_swa")], "SWA_CONFIG"
    if mod_name in UNPORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not yet ported: it needs {UNPORTED[mod_name]}"
        )
    if mod_name not in ARCH_IDS + PAPER_IDS:
        raise ValueError(f"unknown architecture {name!r} (have {ARCH_IDS + PAPER_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    if smoke:
        return mod.SMOKE_CONFIG
    if variant is not None and not hasattr(mod, variant):
        raise ValueError(f"architecture {mod_name!r} has no sliding-window variant")
    return getattr(mod, variant) if variant else mod.CONFIG


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to CPU-steppable size, keeping its family traits
    (qk_norm, qkv_bias, window, norm, activation, the recurrent mixer's
    kind and projection factor)."""
    d_model = min(cfg.d_model, 256)
    att = cfg.attention
    n_heads = 4
    n_kv = max(1, min(att.num_kv_heads * n_heads // max(att.num_heads, 1), n_heads))
    att = AttentionConfig(
        kind="gqa",
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=32,
        qk_norm=att.qk_norm,
        qkv_bias=att.qkv_bias,
        window=min(att.window, 64) if att.window else None,
        rope_theta=att.rope_theta,
    )
    ssm = cfg.ssm
    if ssm is not None:
        ssm = SSMConfig(
            kind=ssm.kind,
            d_state=8,
            d_conv=4,
            expand=2,
            num_heads=4,
            proj_factor=ssm.proj_factor,
        )
    # one superblock of the (possibly shortened) pattern
    pattern = cfg.pattern if len(cfg.pattern) <= 2 else cfg.pattern[:2]
    kw = dict(
        name=cfg.name + "_smoke",
        num_layers=len(pattern),
        d_model=d_model,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 2048),
        max_seq_len=256,
        attention=att,
        ssm=ssm,
        pattern=pattern,
    )
    kw.update(overrides)
    return cfg.replace(**kw)
