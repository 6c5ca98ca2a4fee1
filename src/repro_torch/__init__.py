"""PyTorch + CUDA port of the AVERY serving system, beside the JAX package.

The module tree mirrors ``repro`` one to one (``repro_torch/core/vlm.py``
is held against ``repro/core/vlm.py``, and so on). Parameters are plain
dicts of tensors with the reference's keys and nesting; layer stacks keep
the leading layer axis. The package imports torch, numpy and the standard
library only.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and asking for ``cuda`` without a
card raises instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. Raises if a CUDA device is asked for and there
    is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path")
    return dev


__all__ = ["DeviceLike", "resolve_device"]
