"""Catalog of the ported architectures (port of ``repro/configs/catalog.py``).

Each module exports ``CONFIG`` (the published configuration) and
``SMOKE_CONFIG`` (the same family reduced by ``reduce_for_smoke``);
``phi4_mini_3_8b`` also exports ``SWA_CONFIG``, the sliding-window variant
that ``get_config`` returns for an id ending in ``_swa``. Every id of the
reference's catalog is ported: the dense public architectures, the xLSTM
family (``xlstm_1_3b``: mLSTM and sLSTM blocks in a superblock of 8, without
MLPs), the frontends (``llava_next_34b``'s projected vision prefix,
``musicgen_large``'s four codebooks), the MoE MLP (``mixtral_8x22b``), the
Mamba hybrid (``jamba_v0_1_52b``), MLA attention (``deepseek_v2_236b``) and
the paper's models. An unknown id raises ``ValueError``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (
    INPUT_SHAPES,
    AttentionConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

ARCH_IDS: List[str] = ["llava_next_34b", "mixtral_8x22b", "stablelm_1_6b", "qwen3_0_6b",
                       "qwen1_5_0_5b", "phi4_mini_3_8b", "jamba_v0_1_52b", "deepseek_v2_236b",
                       "xlstm_1_3b", "musicgen_large"]

PAPER_IDS = ["paper_95m", "paper_1b", "paper_3b"]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS + PAPER_IDS}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = _ALIAS.get(name, name).replace("-", "_")
    variant = None
    if mod_name.endswith("_swa"):  # the sliding-window variants
        mod_name, variant = mod_name[: -len("_swa")], "SWA_CONFIG"
    if mod_name not in ARCH_IDS + PAPER_IDS:
        raise ValueError(f"unknown architecture {name!r} (have {ARCH_IDS + PAPER_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    if smoke:
        return mod.SMOKE_CONFIG
    if variant is not None and not hasattr(mod, variant):
        raise ValueError(f"architecture {mod_name!r} has no sliding-window variant")
    return getattr(mod, variant) if variant else mod.CONFIG


def shapes_for(cfg: ModelConfig) -> List[InputShape]:
    """The input shapes an architecture takes: ``long_500k`` only where
    ``supports_long_context`` holds."""
    out = [INPUT_SHAPES["train_4k"], INPUT_SHAPES["prefill_32k"], INPUT_SHAPES["decode_32k"]]
    if cfg.supports_long_context():
        out.append(INPUT_SHAPES["long_500k"])
    return out


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to CPU-steppable size, keeping its family traits
    (qk_norm, qkv_bias, window, MLA's query compression, norm, activation,
    the recurrent mixer's kind and projection factor, the MoE's routing, the
    frontend and the codebooks: a frontend becomes a prefix of 4 tokens of
    width 32)."""
    d_model = min(cfg.d_model, 256)
    att = cfg.attention
    if att.kind == "mla":
        att = AttentionConfig(
            kind="mla",
            num_heads=4,
            num_kv_heads=4,
            qk_norm=att.qk_norm,
            rope_theta=att.rope_theta,
            q_lora_rank=48 if att.q_lora_rank else 0,
            kv_lora_rank=32,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        )
    else:
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
    moe = cfg.moe
    if moe is not None:
        moe = MoEConfig(
            num_experts=min(moe.num_experts, 4),
            top_k=min(moe.top_k, 2),
            num_shared=min(moe.num_shared, 1),
            d_ff_expert=64,
            aux_loss_coef=moe.aux_loss_coef,
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
        moe=moe,
        ssm=ssm,
        pattern=pattern,
        frontend_tokens=4 if cfg.frontend else 0,
        frontend_dim=32 if cfg.frontend else 0,
    )
    kw.update(overrides)
    return cfg.replace(**kw)
