"""Partition rules for every parameter / batch / cache tree (port of
``repro/sharding/specs.py``).

Baseline sharding scheme (the reference's DESIGN.md §7):
  * activations/batch  -> batch dims over ("pod","data"), model dim intact
  * attention          -> heads (fused into the projection output axis)
                          over "model"; output projections over input axis
  * MLPs               -> d_ff over "model" (megatron style)
  * MoE experts        -> expert axis over "model" when divisible, else
                          expert-internal d_ff over "model"
  * Mamba              -> d_inner over "model"
  * embeddings         -> vocab over "model"; norms/routers replicated
  * KV caches          -> batch over ("pod","data"), kv-heads over "model"
                          when divisible

A spec is a tuple with one entry per dimension of its tensor: the mesh
axis (or tuple of axes) the dimension is cut over, or ``None`` where it is
whole, the entries of the reference's ``PartitionSpec``. The rules are the
reference's, applied by key path over the port's trees (dicts and lists of
tensors on any device, ``meta`` included; a list item's key is ``[i]``, as
the reference names a sequence entry), so one rule table serves both
packages. Axes that do not divide evenly fall back to replication
(``_maybe``). A mesh is anything with ``shape`` (axis name -> size) and
``axis_names``: ``launch.mesh``'s local and production meshes.

``shard_shape`` is ``NamedSharding(mesh, spec).shard_shape(shape)``: the
block one device holds, each cut dimension divided by the product of its
axes' sizes, rounded up. ``device_bytes`` sums that block's bytes over a
tree, what one device holds of it (the dry-run's per-device bytes).

``shard_tree`` takes the place of the reference's ``to_shardings``: where
the reference places each leaf on the mesh with a ``NamedSharding``, a
rank of the port holds only its own block, so ``shard_tree`` cuts each
leaf to that block along every axis its spec names.
"""
from __future__ import annotations

from typing import (Any, Callable, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.models.config import ModelConfig

Spec = Tuple[Any, ...]

# parameters whose LAST axis shards over "model" (column parallel)
_COL = {"wq", "wk", "wv", "bq", "bk", "bv", "wq_b", "wkv_b", "w_gate",
        "w_up", "in_proj", "dt_proj", "conv_w", "conv_b", "dt_bias", "D",
        "feat_proj", "vision_proj", "patch_w"}
# parameters whose SECOND-TO-LAST axis shards over "model" (row parallel)
_ROW = {"wo", "w_down", "out_proj", "x_proj", "A_log"}
# always replicated
_REP = {"w", "b", "norm_w", "q_norm", "kv_norm", "router", "patch_b", "pos",
        "scale", "step", "clip_proj", "seg_proj", "w1", "b1", "w2"}


def _axis_size(mesh: Any, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _maybe(dim: int, axis: str, mesh: Any) -> Optional[str]:
    n = _axis_size(mesh, axis)
    return axis if n > 1 and dim % n == 0 else None


def _batch_axes(mesh: Any) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _maybe_batch(dim: int, mesh: Any):
    axes = _batch_axes(mesh)
    total = 1
    for a in axes:
        total *= _axis_size(mesh, a)
    return axes if axes and dim % total == 0 else None


def tree_map_with_path(fn: Callable, tree: Any, path: Tuple[str, ...] = ()
                       ) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists, ``path`` the key
    names from the root (``[i]`` for a list item); the result has the
    tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (f"[{i}]",))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _param_rule(names: Sequence[str], leaf: Any, cfg: ModelConfig,
                mesh: Any) -> Spec:
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    nd = len(shape)

    if name == "embed":
        return (_maybe(shape[0], "model", mesh), None)
    if name in ("head", "answer_head"):
        return (None, _maybe(shape[-1], "model", mesh))
    if name in _REP or nd <= 1:
        return (None,) * nd

    # MoE expert tensors: (L, E, d, f) / (L, E, f, d)
    if name in ("w_gate", "w_up", "w_down") and nd == 4:
        E = shape[1]
        if _maybe(E, "model", mesh):
            return (None, "model", None, None)
        # fall back to expert-internal sharding
        if name == "w_down":
            return (None, None, _maybe(shape[2], "model", mesh), None)
        return (None, None, None, _maybe(shape[3], "model", mesh))

    if name in _COL:
        spec = [None] * nd
        spec[-1] = _maybe(shape[-1], "model", mesh)
        return tuple(spec)
    if name in _ROW and nd >= 2:
        spec = [None] * nd
        spec[-2] = _maybe(shape[-2], "model", mesh)
        return tuple(spec)
    # default: replicate
    return (None,) * nd


def _add_fsdp(spec: Spec, leaf: Any, mesh: Any) -> Spec:
    """ZeRO/FSDP extension: additionally shard the largest still-unsharded
    axis over "data", so parameters + optimizer state are fully sharded."""
    n = _axis_size(mesh, "data")
    shape = tuple(leaf.shape)
    if n <= 1 or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = None, 0
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is None and dim % n == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is None or best_dim < n:
        return spec
    entries[best] = "data"
    return tuple(entries)


def param_specs(cfg: ModelConfig, params: Any, mesh: Any,
                fsdp: bool = False) -> Any:
    def rule(names, leaf):
        spec = _param_rule(names, leaf, cfg, mesh)
        return _add_fsdp(spec, leaf, mesh) if fsdp else spec
    return tree_map_with_path(rule, params)


def _cache_rule(names: Sequence[str], leaf: Any, cfg: ModelConfig,
                mesh: Any) -> Spec:
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    nd = len(shape)
    if name == "positions":                      # (B, W)
        return (_maybe_batch(shape[0], mesh), None)
    # stacked per-layer caches: leading layer axis, then batch
    if name in ("k", "v"):                       # (L, B, W, K, hd)
        kv_ax = _maybe(shape[3], "model", mesh)
        hd_ax = None
        if cfg.shard_cache_hd and kv_ax is None:
            hd_ax = _maybe(shape[4], "model", mesh)
        return (None, _maybe_batch(shape[1], mesh), None, kv_ax, hd_ax)
    if name in ("ckv", "krope"):                 # (L, B, W, r)
        return (None, _maybe_batch(shape[1], mesh), None, None)
    if name == "h":
        if nd == 4:                              # mamba1 (L, B, di, N)
            return (None, _maybe_batch(shape[1], mesh),
                    _maybe(shape[2], "model", mesh), None)
        # mamba2 (L, B, nh, P, N) or hybrid (G, ae, B, nh, P, N)
        b_axis = 1 if nd == 5 else 2
        spec = [None] * nd
        spec[b_axis] = _maybe_batch(shape[b_axis], mesh)
        spec[b_axis + 1] = _maybe(shape[b_axis + 1], "model", mesh)
        return tuple(spec)
    if name == "conv":                           # (L, B, K-1, C) (+hybrid G)
        b_axis = 1 if nd == 4 else 2
        spec = [None] * nd
        spec[b_axis] = _maybe_batch(shape[b_axis], mesh)
        spec[-1] = _maybe(shape[-1], "model", mesh)
        return tuple(spec)
    return (None,) * nd


def cache_specs(cfg: ModelConfig, cache: Any, mesh: Any) -> Any:
    return tree_map_with_path(
        lambda names, leaf: _cache_rule(names, leaf, cfg, mesh), cache)


def _serving_rule(names: Sequence[str], leaf: Any, mesh: Any) -> Spec:
    """Key-path rule for the *paged serving* trees (the in-flight decode
    substrate, not the training state):

      * KV leaves ("k"/"v"): the shared page pool (L, P, page, K, hd), a
        paged prefix (L, n_pages, page, K, hd), or the draft model's
        contiguous ring (L, B, W, K, hd) shard the kv-heads axis (always
        second-to-last) over "model" when divisible; the page / batch /
        width axes replicate, so page-table indirection stays a *local*
        gather on every shard.
      * everything else (page tables, per-slot positions, token ids,
        logits, per-row scalars, MLA latent caches, which do not page)
        replicates.
    """
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    nd = len(shape)
    if name in ("k", "v") and nd >= 2:
        spec = [None] * nd
        spec[-2] = _maybe(shape[-2], "model", mesh)
        return tuple(spec)
    return (None,) * nd


def serving_specs(tree: Any, mesh: Any) -> Any:
    """Specs for any serving tree (pool, paged prefix KV, draft ring cache,
    page tables, logits, scalars) by key path."""
    return tree_map_with_path(
        lambda names, leaf: _serving_rule(names, leaf, mesh), tree)


def _batch_rule(names: Sequence[str], leaf: Any, mesh: Any) -> Spec:
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    nd = len(shape)
    if name == "positions" and nd == 3:          # M-RoPE (3, B, S)
        return (None, _maybe_batch(shape[1], mesh), None)
    if nd == 0:
        return ()
    spec = [None] * nd
    spec[0] = _maybe_batch(shape[0], mesh)
    return tuple(spec)


def batch_specs(batch: Any, mesh: Any) -> Any:
    return tree_map_with_path(
        lambda names, leaf: _batch_rule(names, leaf, mesh), batch)


def opt_state_specs(cfg: ModelConfig, opt_state: Any, pspecs: Any,
                    mesh: Any) -> Any:
    """Optimizer state mirrors the parameter sharding (m, v trees)."""
    return {
        "step": (),
        "m": pspecs,
        "v": pspecs,
    } if set(opt_state) == {"step", "m", "v"} else {
        "step": (), "m": pspecs,
    }


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple)


def block(t: Any, spec: Spec, mesh: Any, coords: Any) -> Any:
    """The block of ``t`` that the rank at ``coords`` (axis name ->
    index) holds under ``spec``: along each named dimension, part
    ``index`` of ``size`` equal parts, where an entry naming several axes
    counts them row-major. A view of ``t``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        index, size = 0, 1
        for a in axes:
            n = _axis_size(mesh, a)
            index = index * n + (coords[a] if a in mesh.axis_names else 0)
            size *= n
        if t.shape[dim] % size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"divide into {size} parts ({entry})")
        part = t.shape[dim] // size
        t = t.narrow(dim, index * part, part)
    return t


def shard_tree(tree: Any, specs: Any, mesh: Any, coords: Any) -> Any:
    """Each leaf of ``tree`` cut to the block its spec gives the rank at
    ``coords`` (``block``), made contiguous: a leaf the spec leaves whole
    is returned as it is, shared with the tree."""
    def cut(t, spec):
        if all(e is None for e in spec):
            return t
        return block(t, spec, mesh, coords).contiguous()

    def walk(t, s):
        if _is_spec(s):
            return cut(t, s)
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        return [walk(a, b) for a, b in zip(t, s)]
    return walk(tree, specs)


def spec_pairs(tree: Any, specs: Any, path: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any, Spec]]:
    """(key path, leaf, spec) of every leaf of a tree and its specs, in
    the tree's order."""
    if _is_spec(specs):
        yield path, tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from spec_pairs(tree[k], specs[k], path + (str(k),))
    else:
        for i, (t, s) in enumerate(zip(tree, specs)):
            yield from spec_pairs(t, s, path + (f"[{i}]",))


def map_with_specs(fn: Callable, tree: Any, specs: Any,
                   path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf, spec)`` over a tree and its specs; the result has
    the tree's structure."""
    if _is_spec(specs):
        return fn(path, tree, specs)
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, tree[k], specs[k], path + (str(k),))
                for k in tree}
    return [map_with_specs(fn, t, s, path + (f"[{i}]",))
            for i, (t, s) in enumerate(zip(tree, specs))]


def leaves_with_paths(tree: Any) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of every leaf, in the tree's order."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _parts(entry: Any, mesh: Any) -> int:
    """How many parts a spec entry cuts its dimension into."""
    if entry is None:
        return 1
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= _axis_size(mesh, a)
    return n


def shard_shape(shape: Sequence[int], spec: Spec,
                mesh: Any) -> Tuple[int, ...]:
    """The shape of one device's block of a ``shape`` leaf under ``spec``
    (ceil division, as ``NamedSharding.shard_shape``)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(dim) // _parts(e, mesh))
                 for dim, e in zip(shape, entries))


def device_bytes(tree: Any, specs: Any, mesh: Any) -> int:
    """Bytes one device holds of ``tree`` (tensors, ``meta`` included)
    placed by ``specs``: each leaf's ``shard_shape`` times its itemsize."""
    total = 0

    def walk(t, s):
        nonlocal total
        if _is_spec(s):
            n = 1
            for dim in shard_shape(t.shape, s, mesh):
                n *= dim
            total += n * t.element_size()
        elif isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
        else:
            for a, b in zip(t, s):
                walk(a, b)
    walk(tree, specs)
    return total
