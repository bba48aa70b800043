"""Catalog of the paper's models (port of ``repro/configs/catalog.py``).

Only the paper's dense nanoGPT models are ported so far; the assigned
public-literature architectures follow with their model families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import AttentionConfig, ModelConfig

PAPER_IDS = ["paper_95m", "paper_1b", "paper_3b"]

_ALIAS = {i.replace("_", "-"): i for i in PAPER_IDS}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = _ALIAS.get(name, name).replace("-", "_")
    if mod_name not in PAPER_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not yet ported (have {PAPER_IDS})"
        )
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a dense attention config to CPU-steppable size."""
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
    pattern = cfg.pattern if len(cfg.pattern) <= 2 else cfg.pattern[:2]
    kw = dict(
        name=cfg.name + "_smoke",
        num_layers=len(pattern),
        d_model=d_model,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 2048),
        max_seq_len=256,
        attention=att,
        pattern=pattern,
    )
    kw.update(overrides)
    return cfg.replace(**kw)
