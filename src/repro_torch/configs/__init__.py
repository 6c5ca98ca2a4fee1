"""Config registries: the LISA pipeline configs and the ten configs of the
architecture zoo.

``get_config(name)`` returns a zoo config as assigned; ``get_reduced(name)``
the smoke-test variant of the same family (2 layers, d_model 256, at most
4 experts), by the reference's reduction rules.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (deepseek_v3_671b, falcon_mamba_7b,
                                 granite_moe_3b, hubert_xlarge, lisa7b,
                                 lisa_mini, lisa_nano, minicpm3_4b,
                                 nemotron_4_340b, phi4_mini_3p8b, qwen15_32b,
                                 qwen2_vl_2b, zamba2_7b)
from repro_torch.models import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (falcon_mamba_7b, nemotron_4_340b, qwen15_32b, phi4_mini_3p8b,
              zamba2_7b, hubert_xlarge, granite_moe_3b, deepseek_v3_671b,
              minicpm3_4b, qwen2_vl_2b)
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
    """Reduced same-family variant: 2 layers, d_model 256, <=4 experts,
    float32."""
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
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.num_shared_experts else 0,
            first_k_dense=min(1, cfg.moe.first_k_dense),
            d_ff_dense=256 if cfg.moe.first_k_dense else 0)
        kw["d_ff"] = 64
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_size=min(cfg.ssm.state_size, 16), head_dim=32)
    if cfg.hybrid is not None:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=1)
    if cfg.rope_style == "mrope":
        kw["mrope_sections"] = (16, 8, 8)  # half-dim 32 with head_dim 64
    return cfg.replace(**kw)
