"""Pytree checkpointing: npz arrays + JSON manifest of the tree structure
(port of ``repro/checkpoint/store.py``).

A directory holds the reference's three files: ``arrays.npz`` (the leaves
as ``leaf_{i}``), ``manifest.json`` (the tree's structure as JAX prints
it, the leaf count, dtypes and shapes) and ``structure.json`` (the
nested dict / list / tuple skeleton). Leaves are numbered as JAX
flattens a tree: dicts in sorted key order, depth first. So a directory
the port writes and one the reference writes for the same tree have the
same manifest and structure text and equal arrays, and each side reads
the other's. bfloat16 leaves are stored as raw 2-byte records (numpy's
``V2``), which is what ``np.savez`` makes of the reference's bfloat16
arrays; the manifest names their dtype. The reader is
``bridge.load_checkpoint``.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.bridge import load_checkpoint


def _flatten(tree: Any):
    """(leaves, treedef text, structure) in JAX's flattening order. A
    ``None`` is an empty node, as in JAX."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            parts = [walk(t[k]) for k in keys]
            text = ", ".join(f"{k!r}: {p[0]}" for k, p in zip(keys, parts))
            return "{" + text + "}", {"__dict__": {
                k: p[1] for k, p in zip(keys, parts)}}
        if isinstance(t, (list, tuple)):
            parts = [walk(v) for v in t]
            text = ", ".join(p[0] for p in parts)
            if isinstance(t, tuple):
                text = "(" + text + ("," if len(parts) == 1 else "") + ")"
            else:
                text = "[" + text + "]"
            return text, {"__list__": [p[1] for p in parts],
                          "__tuple__": isinstance(t, tuple)}
        if t is None:       # no leaf; the reference's skeleton says leaf
            return "None", {"__leaf__": True}
        leaves.append(t)
        return "*", {"__leaf__": True}

    text, struct = walk(tree)
    return leaves, f"PyTreeDef({text})", struct


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save_pytree(path: str, tree: Any) -> None:
    """path is a directory; writes arrays.npz + manifest.json +
    structure.json."""
    os.makedirs(path, exist_ok=True)
    leaves, treedef, struct = _flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"treedef": treedef, "num_leaves": len(leaves),
                   "dtypes": [_dtype_name(l) for l in leaves],
                   "shapes": [list(l.shape) for l in leaves]}, f)
    with open(os.path.join(path, "structure.json"), "w") as f:
        json.dump(struct, f)


def load_pytree(path: str, device: DeviceLike = None) -> Any:
    """The tree of a ``save_pytree`` directory, its leaves tensors on
    ``device`` (default cuda)."""
    return load_checkpoint(path, device)
