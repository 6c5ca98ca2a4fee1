"""Procedural data (port of ``repro/data``): the flood-scene proxy and the
operator request stream. Host-only: numpy and the standard library. The
language-model corpus (``data/lm.py``) comes with training (ROADMAP.md,
Queue 1 item 6)."""
from repro_torch.data import floodseg, requests

__all__ = ["floodseg", "requests"]
