"""Procedural data (port of ``repro/data``): the flood-scene proxy, the
operator request stream and the language-model token streams of the
generic training path. Host-only: numpy and the standard library."""
from repro_torch.data import floodseg, lm, requests

__all__ = ["floodseg", "lm", "requests"]
