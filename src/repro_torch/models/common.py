"""Shared NN primitives: norms, activations, RoPE (incl. M-RoPE), masks,
inits (port of ``repro/models/common.py``).

Plain functions on tensors; every function takes its parameters
explicitly. Norms and RoPE compute in float32 and cast back, as the
reference does.

Tensor parallelism (``sharding.serving``, ``sharding.training``) runs
the model code on one rank's slice of the weights inside
``tensor_parallel(tp)``, as the reference's sharding hints (``wsc``) read
the mesh that ``with mesh:`` installs. The three layers whose weights are
cut along a contracted or gathered axis go through ``row_linear`` (output
projections), and ``embed_rows`` / ``vocab_linear`` (a vocab-sharded
embedding and head): each sums over the ranks through ``tp.reduce``
(Megatron's g). The input of each block whose weights are cut by columns
(attention after its norm, a dense MLP after its norm, and the head
inside ``vocab_linear``) goes through ``block_input``: ``tp.block_input``,
the identity whose backward sums the input's gradient over the ranks
under training (Megatron's f), the identity in serving. Outside a scope
each is the plain product, lookup or identity.

Data parallelism (``sharding.training``) runs the model code on one
rank's share of the batch inside ``data_parallel(dp)``. Where the
reference takes a mean or an order over the whole batch (the
cross-entropy's mean, the MoE router's load statistics, its capacity and
the order in which tokens fill it), the model code reads the other
ranks' shares through ``batch_ranks``, ``batch_total`` and
``batch_before``, so that each rank computes its share of the function
of the whole batch. Outside a scope the model code runs as it did.

The reference's placement hints (``wsc``: ``with_sharding_constraint``
under a mesh, a no-op off one) are ported as ``wsc`` here: the identity
on its tensor, always. Inside ``reckoning(scope)`` (the dry-run's
``launch.dryrun``) a hint also records the activation's spec, "BATCH"
resolved to the scope mesh's batch axes, as the reference resolves it;
the reckoning reads those records.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initialisation (mirrors the reference's distributions, not its bits)
# ---------------------------------------------------------------------------


def normal_init(generator: torch.Generator, shape: Sequence[int],
                scale: float, dtype=torch.float32,
                device=None) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    # scaled in place: a leaf holds one float32 buffer at a time (two
    # would take 35 GiB beside the leaves already made for
    # nemotron-4-340b's 4.7 B-entry embedding and head)
    return x.mul_(scale).to(dtype)


Layers = Union[int, Tuple[int, ...], None]


def leading_axes(layers: Layers) -> Tuple[int, ...]:
    """The leading axes of a stacked leaf: none for one layer (None), a
    layer axis (an int), or several (a tuple)."""
    if layers is None:
        return ()
    return (layers,) if isinstance(layers, int) else tuple(layers)


def fan_in_init(generator: torch.Generator, shape: Sequence[int],
                dtype=torch.float32, device=None,
                layers: Layers = None) -> torch.Tensor:
    """LeCun-style init for a (fan_in, fan_out) weight matrix, stacked
    over ``leading_axes(layers)``."""
    scale = 1.0 / math.sqrt(max(1, shape[0]))
    return normal_init(generator, (*leading_axes(layers), *shape), scale,
                       dtype, device)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def relu2(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": silu, "relu2": relu2, "gelu": gelu}


@contextlib.contextmanager
def full_fp32(*tensors: torch.Tensor):
    """Float32 products on CUDA inside this block are full float32
    products, not TF32, whatever the caller's flags (restored on exit).
    Used where the reference multiplies in float32 on purpose: the MoE
    router, whose top-k ranks near ties, and MLA's float32 attention."""
    if not any(t.is_cuda for t in tensors):
        yield
        return
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = old


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

# the tensor-parallel slice the model code runs in (``tensor_parallel``);
# None outside one. An object with ``sharded(kind)`` (is that layer's
# weight cut over the ranks: "attn", "mlp", "embed" or "head"), ``index``
# and ``size`` (this rank's place on the model axis, its length),
# ``reduce(t)`` (t summed over the ranks) and ``block_input(x)`` (x as the
# input of a column-cut block)
_TENSOR_PARALLEL: contextvars.ContextVar = contextvars.ContextVar(
    "tensor_parallel", default=None)

# the data-parallel share of the batch the model code runs on
# (``data_parallel``); None outside one. An object with ``size`` (the
# ranks the batch is split over), ``total(t)`` (t summed over them, every
# rank's gradient of the sum its own) and ``before(t)`` (the sum of t over
# the ranks before this one, in batch order; no gradient)
_DATA_PARALLEL: contextvars.ContextVar = contextvars.ContextVar(
    "data_parallel", default=None)


@contextlib.contextmanager
def tensor_parallel(tp: Any):
    """Run the model code inside this block as rank ``tp.index`` of a
    tensor-parallel group (restored on exit)."""
    token = _TENSOR_PARALLEL.set(tp)
    try:
        yield tp
    finally:
        _TENSOR_PARALLEL.reset(token)


@contextlib.contextmanager
def data_parallel(dp: Any):
    """Run the model code inside this block on one rank's share of a batch
    split over ``dp.size`` ranks (restored on exit)."""
    token = _DATA_PARALLEL.set(dp)
    try:
        yield dp
    finally:
        _DATA_PARALLEL.reset(token)


def batch_ranks() -> int:
    """How many ranks the batch is split over (1 outside a scope)."""
    dp = _DATA_PARALLEL.get()
    return 1 if dp is None else dp.size


def batch_total(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks the batch is split over (``t`` outside
    a scope)."""
    dp = _DATA_PARALLEL.get()
    return t if dp is None else dp.total(t)


def batch_before(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The sum of ``t`` over the ranks whose share of the batch comes
    before this rank's; None outside a scope."""
    dp = _DATA_PARALLEL.get()
    return None if dp is None else dp.before(t)


def _sharded(kind: str):
    tp = _TENSOR_PARALLEL.get()
    return tp if tp is not None and tp.sharded(kind) else None


# the dry-run's reckoning the model code runs in (``reckoning``); None
# outside one. An object with ``mesh`` (axis names and sizes) and
# ``hint(t, spec)`` (record that ``t`` was placed at ``spec``)
_RECKONING: contextvars.ContextVar = contextvars.ContextVar(
    "reckoning", default=None)


@contextlib.contextmanager
def reckoning(scope: Any):
    """Run the model code inside this block under a dry-run's scope: every
    ``wsc`` hint is reported to ``scope.hint`` (restored on exit)."""
    token = _RECKONING.set(scope)
    try:
        yield scope
    finally:
        _RECKONING.reset(token)


def wsc(x: torch.Tensor, *spec_axes) -> torch.Tensor:
    """The reference's placement hint: returns ``x`` unchanged. Inside a
    ``reckoning`` whose mesh has a "model" axis (the reference constrains
    only then) it reports ``x`` and its spec, "BATCH" resolved to the
    mesh's ("pod", "data") axes present."""
    scope = _RECKONING.get()
    if scope is None or "model" not in scope.mesh.axis_names:
        return x
    batch = tuple(a for a in ("pod", "data")
                  if a in scope.mesh.axis_names)
    scope.hint(x, tuple(batch if a == "BATCH" else a for a in spec_axes))
    return x


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result: for bf16 or fp16 operands on
    CUDA the tensor cores' product with a float32 output
    (``aten::bmm.dtype``), else the float32 product of the upcast operands
    (products of bf16 values are exact in float32, so both compute the
    same sums; the CPU has no ``aten::bmm.dtype``)."""
    w = w.to(x.dtype)
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        out = torch.bmm(x.reshape(1, -1, x.shape[-1]), w[None],
                        out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def row_linear(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """``x @ w`` for an output projection (``kind`` "attn": an attention
    block's ``wo``; "mlp": an MLP's ``w_down``). Where that layer is
    sharded, w holds this rank's rows and x its matching columns: the
    rank's partial product, in float32, is summed over the ranks and
    rounded once to x's dtype."""
    tp = _sharded(kind)
    if tp is None:
        return linear(x, w)
    return tp.reduce(matmul_f32(x, w)).to(x.dtype)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of an embedding table (V, d) for integer ``tokens``. Where
    the table is vocab-sharded, this rank holds rows [index * n, (index +
    1) * n): it looks up the tokens that fall there, zeros for the rest,
    and the ranks' rows are summed (in float32; adding zeros is exact)."""
    tp = _sharded("embed")
    if tp is None:
        return table[tokens.long()]
    n = table.shape[0]
    local = tokens.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].float()
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return tp.reduce(rows).to(table.dtype)


def block_input(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` as the input of a block whose weights are cut by columns
    (``kind`` "attn" or "mlp"): where that layer is sharded,
    ``tp.block_input(x)``, else ``x``."""
    tp = _sharded(kind)
    return x if tp is None else tp.block_input(x)


def vocab_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for an output head (d, V). Where the head is
    vocab-sharded, this rank's columns are computed (from
    ``tp.block_input(x)``), placed into a zero-filled full row and summed
    over the ranks (in float32; adding zeros is exact), so every rank
    holds the whole logits."""
    tp = _sharded("head")
    if tp is None:
        return linear(x, w)
    part = linear(tp.block_input(x), w)
    n = part.shape[-1]
    full = part.new_zeros((*part.shape[:-1], n * tp.size),
                          dtype=torch.float32)
    full[..., tp.index * n:(tp.index + 1) * n] = part
    return tp.reduce(full).to(part.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., dim//2) in float32."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    return positions.float()[..., None] * inv_freq


def _apply_angles(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half convention. x (B, S, H, D); angles (B, S, D//2)."""
    dtype = x.dtype
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    cos = torch.cos(angles)[..., None, :]             # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Standard 1-D RoPE. x: (B, S, H, D), positions: (B, S)."""
    return _apply_angles(x, _rope_angles(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int],
                theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL). x (B, S, H, D); positions (3, B, S), the
    (t, h, w) streams. ``sections`` partitions the half-dim (their sum must
    be D // 2); section i takes its angles from stream i."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"the half head dim {half}")
    parts, lo = [], 0
    for i, sec in enumerate(sections):
        exps = torch.arange(lo, lo + sec, dtype=torch.float32,
                            device=positions.device) / half
        parts.append(positions[i].float()[..., None] * (1.0 / theta ** exps))
        lo += sec
    return _apply_angles(x, torch.cat(parts, dim=-1))


def sinusoid_positions(seq_len: int, dim: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Additive sinusoidal position table (S, dim) for encoder-only
    models: sines then cosines."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# masking helpers (additive, with the finite NEG_INF of the reference)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def causal_mask(seq_len: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(S, S) additive mask. window=None -> full causal; else sliding."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    ok = j <= i
    if window is not None:
        ok = ok & (j > i - window)
    return _additive(ok)


def cache_mask(cache_positions: torch.Tensor, pos,
               window: Optional[int] = None) -> torch.Tensor:
    """Additive mask over cache slots for single-token decode.

    cache_positions: (B, W) absolute position per slot (-1 = empty);
    pos: the decoded token's position — a scalar, or (B, 1) per row.
    """
    ok = (cache_positions >= 0) & (cache_positions <= pos)
    if window is not None:
        ok = ok & (cache_positions > pos - window)
    return _additive(ok)


def _additive(ok: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)
