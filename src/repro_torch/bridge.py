"""Weight bridge: the reference's parameter pytrees (numpy leaves, e.g.
``np.asarray`` of each JAX leaf) -> torch tensors with the same dict and
list structure, on a given device. Also reads a ``checkpoint/store.py``
directory (``arrays.npz`` + ``manifest.json`` + ``structure.json``)
without JAX.

numpy has no native bfloat16: such leaves arrive either with the
``bfloat16`` extension dtype (from ``np.asarray`` of a JAX array) or, from
an npz file, as raw 2-byte records that the manifest names ``bfloat16``.
Both are reinterpreted bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def _leaf_to_torch(a, device: torch.device,
                   dtype_name: Optional[str] = None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)                     # an owned, writable, C-order copy
    if (dtype_name or a.dtype.name) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_torch(tree: Any, device: DeviceLike = None) -> Any:
    """Same structure, every leaf a tensor on ``device`` (default cuda)."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return _leaf_to_torch(t, dev)

    return walk(tree)


def _from_jsonable(spec, leaves_iter):
    if "__leaf__" in spec:
        return next(leaves_iter)
    if "__dict__" in spec:
        return {k: _from_jsonable(v, leaves_iter)
                for k, v in spec["__dict__"].items()}
    vals = [_from_jsonable(v, leaves_iter) for v in spec["__list__"]]
    return tuple(vals) if spec.get("__tuple__") else vals


def load_checkpoint(path: str, device: DeviceLike = None) -> Any:
    """Read a ``checkpoint/store.py:save_pytree`` directory into tensors."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "structure.json")) as f:
        struct = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [_leaf_to_torch(data[f"leaf_{i}"], dev, name)
                  for i, name in enumerate(manifest["dtypes"])]
    if len(leaves) != manifest["num_leaves"]:
        raise ValueError(f"{path}: {len(leaves)} leaves, manifest says "
                         f"{manifest['num_leaves']}")
    return _from_jsonable(struct, iter(leaves))
