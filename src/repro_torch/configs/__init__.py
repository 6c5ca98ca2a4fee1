"""LISA pipeline config registry."""
from __future__ import annotations

from repro_torch.configs import lisa7b, lisa_mini, lisa_nano

LISA_REGISTRY = {
    lisa7b.CONFIG.name: lisa7b.CONFIG,
    lisa_mini.CONFIG.name: lisa_mini.CONFIG,
    lisa_nano.CONFIG.name: lisa_nano.CONFIG,
}


def get_lisa_config(name: str = "lisa-7b"):
    if name not in LISA_REGISTRY:
        raise KeyError(f"unknown LISA config {name!r}; have "
                       f"{sorted(LISA_REGISTRY)}")
    return LISA_REGISTRY[name]
