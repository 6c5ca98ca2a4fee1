"""Config registries: the LISA pipeline configs and the ported configs of
the architecture zoo.

``get_config(name)`` returns a zoo config as assigned; ``get_reduced(name)``
the smoke-test variant of the same family (2 layers, d_model 256), by the
reference's reduction rules. The zoo registry holds the two SSM configs;
the attention and MoE zoo waits for ROADMAP.md, Queue 1 item 3a.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (falcon_mamba_7b, lisa7b, lisa_mini,
                                 lisa_nano, zamba2_7b)
from repro_torch.models import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG for c in (falcon_mamba_7b, zamba2_7b)
}

LISA_REGISTRY = {
    lisa7b.CONFIG.name: lisa7b.CONFIG,
    lisa_mini.CONFIG.name: lisa_mini.CONFIG,
    lisa_nano.CONFIG.name: lisa_nano.CONFIG,
}

ARCH_IDS: List[str] = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    return REGISTRY[name]


def get_lisa_config(name: str = "lisa-7b"):
    if name not in LISA_REGISTRY:
        raise KeyError(f"unknown LISA config {name!r}; have "
                       f"{sorted(LISA_REGISTRY)}")
    return LISA_REGISTRY[name]


def get_reduced(name: str) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model 256, float32."""
    cfg = get_config(name)
    kw: dict = {
        "name": cfg.name + "-reduced",
        "num_layers": 2,
        "d_model": 256,
        "num_heads": 4,
        "num_kv_heads": min(4, cfg.num_kv_heads),
        "head_dim": 64 if cfg.head_dim else 0,
        "d_ff": min(cfg.d_ff, 512) if cfg.d_ff else 0,
        "vocab_size": min(cfg.vocab_size, 512),
        "param_dtype": "float32",
        "act_dtype": "float32",
        "mtp": False,
        "num_vision_tokens": min(cfg.num_vision_tokens, 8),
        "frontend_dim": min(cfg.frontend_dim, 32) if cfg.frontend_dim else 0,
    }
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_size=min(cfg.ssm.state_size, 16), head_dim=32)
    if cfg.hybrid is not None:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=1)
    return cfg.replace(**kw)
