"""Multi-pod dry-run: a reckoning from the specs (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles every (architecture x input shape) on
its production meshes and reads the compiler's analyses. The port has no
GSPMD compiler, so its dry-run is a reckoning: the ported spec rules
(``sharding.specs``) over abstract trees on the meta device (nothing is
allocated), and the step one device runs, executed on meta tensors.

For each combo the record holds:
  * ``device_bytes``: the bytes one device holds of the step's arguments,
    by tree ("params"; train: "opt_state", AdamW's step and float32 m and
    v; "batch"; decode: "cache") and their "total". Each leaf counts its
    ``specs.shard_shape`` on the mesh times its itemsize
    (``param_specs(fsdp=)``, ``opt_state_specs``, ``batch_specs``,
    ``cache_specs``). This is the arguments' share alone: no temporaries,
    no outputs.
  * with costs (by default on the single-pod mesh only; a multi-pod combo
    records its bytes alone, as the reference's ``with_costs`` default
    does): ``flops``, ``bytes`` and ``collectives`` of the step one device
    runs, ``model_flops``, and the roofline terms.

The step one device runs: train is ``make_train_step`` with AdamW (loss,
backward, update), prefill ``prefill_step``, decode ``decode_step`` at
position seq_len - 1, on meta tensors:
  * the batch is the device's share (a batch dimension that the batch
    axes do not divide stays whole, as ``batch_specs`` leaves it);
  * every weight is cut by its spec's "model" entries (FSDP's "data"
    entries are gathered before use), so a leaf that falls back to
    replication keeps its whole axis: the embedding and head at their
    vocab cut, dense MLPs at their d_ff cut, attention at H/m query and
    K/m kv heads where its cut falls on whole heads (m the "model" axis'
    size), and decode caches at that kv-head cut;
  * the share rule, for cuts the model code cannot run locally: an
    attention block whose q/k/v cut does not fall on whole heads
    (granite's 24 x 64 query columns give a rank 96, 1.5 heads), a MoE
    layer's expert products (cut on the expert axis or inside the
    experts), a Mamba mixer (cut on d_inner) and an audio / VLM input
    projection (cut on d_model) run at the whole width, and each of their
    ops counts 1/m of its FLOPs and bytes (the share). Their backward ops
    share alike: an autograd node created inside such a block carries
    its share (by the node's sequence number).

What is counted:
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (its formulas for
    matmul, bmm, convolution and attention ops), each op times its share.
    On meta ``common.matmul_f32`` takes its upcast route (float32 copies,
    then a float32 product), not ``aten::bmm.dtype``: the same FLOPs.
  * bytes: every aten op's operands plus results, unfused (view ops
    skipped), times the share: above what fused kernels move, and the
    upcast copies above included.
The backward's shares rest on two private autograd calls, both in
``_autograd_sequence``; ``tests/test_torch_dryrun.py`` fails by name if a
torch release changes them.
  * collectives: the result bytes each device receives from each
    collective, by the port's own placement of collectives (the keys of
    the reference's ``collective_bytes``).

The collective model. Forward: the sums over the "model" axis, one
all-reduce each.
  * Those the model code runs, counted by a stand-in for
    ``sharding.serving.TensorParallel`` whose ``reduce`` records the bytes
    of its tensor and returns it: ``row_linear`` (attention's ``wo``, an
    MLP's ``w_down``: the float32 partial product), ``embed_rows`` (a
    float32 (B, S, d) block) and ``vocab_linear`` (a float32 row of the
    full vocabulary).
  * Those of the blocks that tensor-parallel serving never cuts, charged
    by the reckoning itself when the block returns (``_summed``): a Mamba
    mixer cut on d_inner sums its row-parallel products' float32 partials
    (Mamba-1: ``x_proj``'s (..., R + 2N) and ``out_proj``'s (..., d);
    Mamba-2: ``out_proj``'s), a MoE layer whose experts are cut its routed
    output, (B * S, d) in float32.
Train adds:
  * the backward all-reduce of each column-parallel input (Megatron's
    conjugate pair): one a forward sum of a block (attention, MLP, mixer,
    experts), of its tensor's shape in the activation dtype; for the head,
    one of its input's gradient, (..., d) in the activation dtype; none
    for the embedding, whose table's gradient is local;
  * FSDP: each leaf whose spec names "data" is all-gathered over "data"
    before the forward and again before the backward (result: its
    model-local block), its gradient reduce-scattered (result: its shard)
    and, on a mesh with "pod", that shard all-reduced over "pod";
  * data parallelism: the gradient of every other leaf is all-reduced over
    the batch axes (its model-local block), where the batch is cut.
The placement hints (``common.wsc``) are recorded (``hints``); the rules
that charge them:
  * a ``seq_shard`` hint (``stack._seq_wsc``: the residual stream cut on
    its sequence over "model"): one all-gather of the whole (B, S, d)
    stream a hint; train adds a reduce-scatter of its 1/m;
  * a ``shard_cache_hd`` decode layer (three hints, q, k and v cut on the
    head dim): one all-reduce of its float32 scores (B, H, 1, W), the
    partial sums over the head dim;
  * an expert-buffer hint (``moe._buf_spec``, the grouped dispatch's batch
    spec): nothing; every rank builds its experts' buffers from tokens it
    holds, and the layer's one sum is its routed output's (above).
No all-to-all and no collective-permute arise in this model (the split
serve step's ppermute is ``launch.serve``'s). Each charge also carries its
rule's label (``by_label``: "tp" for the sums the model code runs, "block"
for those of the blocks the share rule runs whole, "seq", "hd",
"fsdp-gather", "fsdp-scatter", "pod", "dp"), the labels under which the
executed sharded train step (``sharding.training``) counts its own
collectives; ``held_to_reckoning`` holds one to the other and names the
departures.

Not ported: the reference's depth-variant extrapolation
(``measure_costs``), which exists because XLA's ``cost_analysis`` counts a
``lax.scan`` body once; the counter here sees every layer. Nor
``collective_bytes``, the parser of partitioned HLO, which has no input
here.

Roofline terms use the card's constants (``network.energy.H100_SXM``:
989e12 dense bf16 FLOP/s, 3.35e12 HBM bytes/s) and NVLink 4 at 450e9
bytes/s per direction (``NVLINK_BW``); ``useful_flops_ratio`` and
``bottleneck`` follow the reference.

Records go to ``build/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``.

  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from bisect import bisect_right
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch import optim
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention, common, moe, ssm, stack
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.network.energy import H100_SXM
from repro_torch.sharding import specs as sh

META = torch.device("meta")
OUT_DIR = "build/dryrun_torch"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SLIDING_WINDOW = 8192            # long_500k variant for dense archs


def adapt_config(cfg: ModelConfig, shape: ShapeSpec) -> Optional[ModelConfig]:
    """Apply shape-dependent config adaptation; None => combo skipped."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return None              # encoder-only (hubert): no decode exists
    if shape.name == "long_500k" and not cfg.subquadratic:
        if cfg.arch_type in ("dense", "moe", "vlm"):
            return cfg.with_sliding_window(SLIDING_WINDOW)
        return None
    if shape.name == "long_500k" and cfg.arch_type == "hybrid":
        # the shared attention block also windows at 500k context
        return cfg.with_sliding_window(SLIDING_WINDOW)
    return cfg


def cache_width(cfg: ModelConfig, shape: ShapeSpec) -> int:
    w = shape.seq_len
    if cfg.sliding_window:
        w = min(w, cfg.sliding_window)
    return w


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta stand-ins for every model input (the reference's shapes and
    dtypes; nothing allocated)."""
    B, S = shape.global_batch, shape.seq_len
    tok, act = torch.int32, cfg.adtype
    if shape.kind in ("train", "prefill"):
        if cfg.modality == "audio":
            return {"frames": _meta((B, S, cfg.frontend_dim), act),
                    "targets": _meta((B, S), tok),
                    "mask_positions": _meta((B, S), torch.bool)}
        if cfg.modality == "vlm":
            return {"tokens": _meta((B, S), tok),
                    "vision_embeds": _meta((B, cfg.num_vision_tokens,
                                            cfg.frontend_dim), act),
                    "positions": _meta((3, B, S), tok)}
        return {"tokens": _meta((B, S), tok)}
    # decode: one token against a seq_len context
    return {"tokens": _meta((B, 1), tok), "pos": _meta((), tok)}


def abstract_params(cfg: ModelConfig):
    return model_lib.init_params(cfg, torch.Generator(), device=META)


def abstract_cache(cfg: ModelConfig, shape: ShapeSpec):
    return model_lib.init_cache(cfg, shape.global_batch,
                                cache_width(cfg, shape), device=META)


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------


def device_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh: Any,
                 fsdp: bool = False) -> Dict[str, int]:
    """What one device holds of the step's arguments, by tree."""
    aparams = abstract_params(cfg)
    pspecs = sh.param_specs(cfg, aparams, mesh, fsdp=fsdp)
    batch = input_specs(cfg, shape)
    out = {"params": sh.device_bytes(aparams, pspecs, mesh)}
    if shape.kind == "train":
        aopt = optim.adamw(3e-4).init(aparams)
        out["opt_state"] = sh.device_bytes(
            aopt, sh.opt_state_specs(cfg, aopt, pspecs, mesh), mesh)
    out["batch"] = sh.device_bytes(batch, sh.batch_specs(batch, mesh), mesh)
    if shape.kind == "decode":
        acache = abstract_cache(cfg, shape)
        out["cache"] = sh.device_bytes(acache, sh.cache_specs(cfg, acache,
                                                              mesh), mesh)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# the reckoning of one device's step
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# ops that move no bytes (views are skipped by ``OpOverload.is_view``)
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}
_EXPERT = ("w_gate", "w_up", "w_down")


def empty_collectives() -> Dict[str, int]:
    out = {c: 0 for c in _COLLECTIVES}
    out.update(count=0, total=0)
    return out


def charge(collectives: Dict[str, int], kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` whose result is ``nbytes``."""
    collectives[kind] += int(nbytes)
    collectives["count"] += 1
    collectives["total"] += int(nbytes)


def _has(entry: Any, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def _cut_shape(shape, spec, mesh, axes) -> Tuple[int, ...]:
    """``shape`` cut along the spec's entries that name one of ``axes``."""
    kept = tuple(e if any(_has(e, a) for a in axes) else None for e in spec)
    return sh.shard_shape(shape, kept, mesh)


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass
class Plan:
    """How one device runs a model on a mesh: the "model" axis size,
    attention's mode ("whole": not cut; "local": cut on whole heads;
    "shared": the share rule), the share of each block kind run whole
    ("attn", "experts", "mixer", "input"), the layer kinds whose sums the
    model code runs over the ranks (``TensorParallel.sharded``), and the
    blocks whose sums the reckoning charges itself ("experts", "mixer")."""
    m: int
    attn: str
    shares: Dict[str, Fraction]
    kinds: frozenset
    sums: frozenset


def cut_plan(cfg: ModelConfig, aparams: Any, pspecs: Any, mesh: Any) -> Plan:
    m = mesh.shape.get("model", 1)
    cut: Dict[str, bool] = {}
    for path, leaf, spec in sh.spec_pairs(aparams, pspecs):
        name = path[-1]
        if name in ("wq", "wk", "wq_b", "wo") and "attn" in path:
            cut.setdefault(name, _has(spec[-1 if name != "wo" else -2],
                                      "model"))
        elif name == "w_down" and "moe" in path and "shared" not in path:
            cut.setdefault("experts", any(_has(e, "model") for e in spec))
        elif name == "w_down":
            cut.setdefault("mlp", _has(spec[-2], "model"))
        elif name in ("in_proj", "out_proj") and "mixer" in path:
            cut.setdefault(name, any(_has(e, "model") for e in spec))
        elif name in ("feat_proj", "vision_proj"):
            cut["input"] = _has(spec[-1], "model")
        elif name in ("embed", "head") and len(path) == 1:
            cut[name] = _has(spec[0 if name == "embed" else -1], "model")
    share = Fraction(1, m)
    shares: Dict[str, Fraction] = {}
    kinds, sums = set(), set()
    attn = "whole"
    if cut.get("wq", cut.get("wq_b", False)):
        H, K = cfg.num_heads, cfg.num_kv_heads
        aligned = (H % m == 0 and (cfg.attn_type == "mla"
                                   or (K % m == 0 and cut.get("wk"))))
        attn = "local" if aligned else "shared"
        if not aligned:
            shares["attn"] = share
    if cut.get("wo"):
        kinds.add("attn")
    if cut.get("mlp"):
        kinds.add("mlp")
    if cut.get("experts"):
        shares["experts"] = share
        sums.add("experts")
    if cut.get("in_proj"):
        shares["mixer"] = share
    if cut.get("out_proj"):
        sums.add("mixer")
    if cut.get("input"):
        shares["input"] = share
    if cut.get("embed"):
        kinds.add("embed")
    if cut.get("head") or (cfg.tie_embeddings and cut.get("embed")):
        kinds.add("head")
    return Plan(m, attn, shares, frozenset(kinds), frozenset(sums))


def runs_whole(path: Tuple[str, ...], plan: Plan) -> bool:
    """Does this leaf run at its whole width (the share rule)?"""
    name = path[-1]
    if "attn" in path and plan.attn == "shared":
        return True
    if "moe" in path and name in _EXPERT and "shared" not in path:
        return True
    if "mixer" in path or name in ("feat_proj", "vision_proj"):
        return True
    return False


def local_config(cfg: ModelConfig, plan: Plan) -> ModelConfig:
    if plan.attn != "local":
        return cfg
    return cfg.replace(num_heads=cfg.num_heads // plan.m,
                       num_kv_heads=cfg.num_kv_heads // plan.m,
                       head_dim=cfg.resolved_head_dim)


def _autograd_sequence(running: bool = False) -> Optional[int]:
    """The private autograd API the share rule reads, all of it: the
    sequence number the next autograd node will take, or (``running``)
    that of the node the backward runs now, None outside one."""
    if not running:
        return torch._C._autograd._get_sequence_nr()
    node = torch._C._current_autograd_node()
    return None if node is None else node._sequence_nr()


class Scope:
    """One reckoning: FLOPs, bytes, collectives and hints of one device's
    step, with the shares of the blocks run whole."""

    def __init__(self, cfg: ModelConfig, mesh: Any, plan: Plan,
                 train: bool = False, width: int = 0):
        self.cfg, self.mesh, self.plan = cfg, mesh, plan
        self.train, self.width = train, width
        self.act_item = torch.empty((), dtype=cfg.adtype).element_size()
        self.bytes = Fraction(0)
        self.collectives = empty_collectives()
        # the same charges by their rule's label, each kind's count and
        # bytes (the shape of ``launch.mesh.Mesh.collectives``)
        self.labels: Dict[str, Dict[str, Dict[str, int]]] = {}
        self.hints: List[Tuple[Tuple[int, ...], tuple]] = []
        self._stack: List[Fraction] = []
        self._spans: List[Tuple[int, int, Fraction]] = []
        self._hd: List[torch.Tensor] = []

    # ---- shares ----

    def share(self) -> Fraction:
        """The share of the op running now: its block's in the forward;
        in the backward, that of the block whose forward made the autograd
        node running it."""
        seq = _autograd_sequence(running=True)
        if seq is None:
            return self._stack[-1] if self._stack else Fraction(1)
        i = bisect_right(self._spans, (seq, float("inf"))) - 1
        if i >= 0 and self._spans[i][0] < seq < self._spans[i][1]:
            return self._spans[i][2]
        return Fraction(1)

    def shared(self, fn, share: Fraction):
        """``fn`` counted at ``share``, its backward nodes too."""
        def run(*args, **kwargs):
            lo = _autograd_sequence()
            self._stack.append(share)
            try:
                out = fn(*args, **kwargs)
            finally:
                self._stack.pop()
            hi = _autograd_sequence()
            if hi > lo:
                self._spans.append((lo - 1, hi, share))
            return out
        return run

    def flop_mapping(self) -> Dict[Any, Any]:
        def scaled(formula):
            def count(*args, **kwargs):
                return formula(*args, **kwargs) * self.share()
            count._get_raw = True
            return count
        return {op: scaled(f) for op, f in flop_registry.items()}

    # ---- collectives ----

    def charge(self, kind: str, nbytes: int, label: str) -> None:
        charge(self.collectives, kind, nbytes)
        entry = self.labels.setdefault(label, {}).setdefault(
            kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += int(nbytes)

    def block_sum(self, numel: int, label: str) -> None:
        """A block's forward sum of ``numel`` float32 partials over the
        "model" axis and, under train, its backward conjugate."""
        self.charge("all-reduce", numel * 4, label)
        if self.train:
            self.charge("all-reduce", numel * self.act_item, label)

    def reduce(self, t: torch.Tensor, kind: str) -> None:
        """A sum the model code runs over the "model" axis (and, under
        train, its backward conjugate): label "tp", or "block" for the
        output projection of attention the share rule runs whole."""
        if kind in ("attn", "mlp"):
            shared = kind == "attn" and self.plan.attn == "shared"
            self.block_sum(t.numel(), "block" if shared else "tp")
            return
        self.charge("all-reduce", t.nbytes, "tp")
        if self.train and kind == "head":
            rows = t.numel() // t.shape[-1]
            self.charge("all-reduce", rows * self.cfg.d_model * self.act_item,
                        "tp")

    def hint(self, t: torch.Tensor, spec: tuple) -> None:
        self.hints.append((tuple(t.shape), spec))
        if self.plan.m == 1:
            return
        if t.dim() == 3 and isinstance(spec[0], tuple) and spec[1] == "model":
            self.charge("all-gather", t.nbytes, "seq")    # seq_shard
            if self.train:
                self.charge("reduce-scatter", t.nbytes // self.plan.m, "seq")
        elif t.dim() == 4 and spec[-1] == "model":        # shard_cache_hd
            self._hd.append(t)
            if len(self._hd) == 3:
                B, S, H, _ = self._hd[0].shape
                self.charge("all-reduce", B * H * S * self.width * 4, "hd")
                self._hd.clear()

    def gradient_collectives(self, aparams: Any, pspecs: Any,
                             batch_cut: Dict[str, bool]) -> None:
        """FSDP's gathers and reduce-scatters and the data-parallel
        gradient sums of a train step (the model in the docstring)."""
        pod = batch_cut.get("pod", False)
        any_cut = any(batch_cut.values())
        for _, leaf, spec in sh.spec_pairs(aparams, pspecs):
            local = _nbytes(_cut_shape(leaf.shape, spec, self.mesh,
                                       ("model",)), leaf.dtype)
            if any(_has(e, "data") for e in spec):
                shard = _nbytes(sh.shard_shape(leaf.shape, spec, self.mesh),
                                leaf.dtype)
                self.charge("all-gather", local, "fsdp-gather")
                self.charge("all-gather", local, "fsdp-gather")
                self.charge("reduce-scatter", shard, "fsdp-scatter")
                if pod:
                    self.charge("all-reduce", shard, "pod")
            elif any_cut:
                self.charge("all-reduce", local, "dp")


class _CountingTP:
    """A stand-in for ``sharding.serving.TensorParallel`` that moves
    nothing: ``reduce`` records the sum's bytes and returns its tensor.
    Rank 0 of ``size`` (so ``vocab_linear`` builds the full row)."""

    index = 0

    def __init__(self, scope: Scope):
        self.scope = scope
        self.kinds = scope.plan.kinds
        self.size = scope.plan.m
        self._kind = ""

    def sharded(self, kind: str) -> bool:
        self._kind = kind
        return kind in self.kinds

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        self.scope.reduce(t, self._kind)
        return t

    def block_input(self, x: torch.Tensor) -> torch.Tensor:
        # its backward sum is charged with the block's forward sum
        return x


class _ByteCounter(TorchDispatchMode):
    """Every op's operand and result bytes, times its share."""

    def __init__(self, scope: Scope):
        super().__init__()
        self.scope = scope

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func not in _NO_TRAFFIC:
            n = sum(t.nbytes for t in tree_flatten((args, kwargs, out))[0]
                    if isinstance(t, torch.Tensor))
            self.scope.bytes += n * self.scope.share()
        return out


@contextlib.contextmanager
def _patched(module: Any, name: str, fn: Any):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def _summed(scope: Scope, fn, widths):
    """``fn(p, cfg, x, ...)`` followed by its block's sums over the ranks,
    one a width of ``widths(cfg)``, each over x's rows."""
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        x = args[2]
        for w in widths(args[1]):
            scope.block_sum(x.numel() // x.shape[-1] * w, "block")
        return out
    return run


def _mixer_widths(cfg: ModelConfig) -> List[int]:
    """The output widths of a Mamba mixer's row-parallel products."""
    if cfg.ssm.version == 1:
        return [ssm._dt_rank(cfg) + 2 * cfg.ssm.state_size, cfg.d_model]
    return [cfg.d_model]


@contextlib.contextmanager
def _share_blocks(scope: Scope):
    """Install the share rule's blocks, and the sums the reckoning charges
    itself, for this reckoning."""
    shares, sums = scope.plan.shares, scope.plan.sums
    with contextlib.ExitStack() as stack_:
        if "attn" in shares:
            for name in ("attn_full", "attn_decode"):
                stack_.enter_context(_patched(attention, name, scope.shared(
                    getattr(attention, name), shares["attn"])))
        if "experts" in shares:
            stack_.enter_context(_patched(moe, "_expert_ffn", scope.shared(
                moe._expert_ffn, shares["experts"])))
        if "experts" in sums:
            stack_.enter_context(_patched(moe, "moe_mlp", _summed(
                scope, moe.moe_mlp, lambda c: [c.d_model])))
        for name in ("mamba1_full", "mamba2_full", "mamba1_step",
                     "mamba2_step"):
            fn = getattr(ssm, name)
            if "mixer" in shares:
                fn = scope.shared(fn, shares["mixer"])
            if "mixer" in sums:
                fn = _summed(scope, fn, _mixer_widths)
            if fn is not getattr(ssm, name):
                stack_.enter_context(_patched(ssm, name, fn))
        if "input" in shares:
            inner = scope.shared(model_lib._embed_inputs, shares["input"])

            def embed_inputs(p, c, batch):
                x, positions = inner(p, c, batch)
                # the projected frames / patches are gathered back whole
                n = (x.shape[1] if c.modality == "audio"
                     else c.num_vision_tokens)
                whole = x.shape[0] * n * x.shape[2] * x.element_size()
                scope.charge("all-gather", whole, "block")
                if scope.train:
                    scope.charge("reduce-scatter", whole // scope.plan.m,
                                 "block")
                return x, positions
            stack_.enter_context(_patched(model_lib, "_embed_inputs",
                                          embed_inputs))
        yield


def _batch_cut(batch: Dict[str, Any], mesh: Any) -> Dict[str, bool]:
    """Which batch axes (of size > 1) cut the batch."""
    lead = next(t for k, t in batch.items() if k != "positions" and t.dim())
    axes = sh._maybe_batch(lead.shape[0], mesh) or ()
    return {a: mesh.shape[a] > 1 for a in axes}


def _local_step(cfg: ModelConfig, view: Any, mesh: Any, train: bool = False,
                width: int = 0, fsdp: bool = False):
    """The rank-local side of a reckoning over the parameter tree ``view``:
    its specs, the cut plan, its leaves on meta at their rank-local widths
    (those the share rule runs whole at their whole width), the local
    config and the scope. Returns (scope, local view, local config,
    specs)."""
    specs = sh.param_specs(cfg, view, mesh, fsdp=fsdp)
    plan = cut_plan(cfg, view, specs, mesh)
    local = sh.map_with_specs(lambda path, t, s: _meta(
        t.shape if runs_whole(path, plan) else
        _cut_shape(t.shape, s, mesh, ("model",)), t.dtype), view, specs)
    scope = Scope(cfg, mesh, plan, train=train, width=width)
    return scope, local, local_config(cfg, plan), specs


def reckon(cfg: ModelConfig, shape: ShapeSpec, mesh: Any,
           fsdp: bool = False) -> Dict[str, Any]:
    """FLOPs, bytes, collectives and hints of the step one device runs
    (the module docstring's model)."""
    aparams = abstract_params(cfg)
    train = shape.kind == "train"
    scope, params, lcfg, pspecs = _local_step(
        cfg, aparams, mesh, train=train, width=cache_width(cfg, shape),
        fsdp=fsdp)
    plan = scope.plan
    gbatch = input_specs(cfg, shape)
    batch = sh.map_with_specs(
        lambda path, t, s: _meta(sh.shard_shape(t.shape, s, mesh), t.dtype),
        gbatch, sh.batch_specs(gbatch, mesh))
    if train:
        opt = optim.adamw(3e-4)
        state = opt.init(params)

        def step():
            model_lib.make_train_step(lcfg, opt)(params, state, batch)
    elif shape.kind == "prefill":
        def step():
            model_lib.prefill_step(params, lcfg, batch)
    else:
        gcache = abstract_cache(cfg, shape)
        cspecs = sh.cache_specs(cfg, gcache, mesh)
        axes = ("pod", "data") + (("model",) if plan.attn == "local"
                                  else ())
        cache = sh.map_with_specs(lambda path, t, s: _meta(
            _cut_shape(t.shape, s, mesh, axes if path[-1] in ("k", "v")
                       else ("pod", "data")), t.dtype), gcache, cspecs)

        def step():
            model_lib.decode_step(params, lcfg, cache, batch["tokens"],
                                  shape.seq_len - 1)
    flops = _counted(scope, step)
    if train:
        scope.gradient_collectives(aparams, pspecs, _batch_cut(gbatch, mesh))
    return {"flops": float(flops), "bytes": float(scope.bytes),
            "collectives": dict(scope.collectives),
            "by_label": scope.labels,
            "hints": len(scope.hints), "attention": plan.attn,
            "shares": sorted(plan.shares)}


# How the executed sharded train step (``sharding.training``) departs from
# the reckoning's model, by label (``Mesh.collectives``): the labels held
# equal, kind by kind, count and bytes; those only the reckoning charges
# (the sums of the blocks the share rule runs whole, the sequence hints);
# those only the step executes (each whole-run block's leaves gathered over
# "model" before use, the global-batch statistics' sums, the global norm's
# sum). FSDP: the step gathers a leaf once and keeps the gathered block for
# the backward, where the reckoning charges a gather before each pass.
HELD_LABELS = ("tp", "dp", "fsdp-scatter", "pod")
RECKONED_ONLY = ("block", "seq")
EXECUTED_ONLY = ("whole", "stat", "norm")


def held_to_reckoning(reck: Dict[str, Dict[str, Dict[str, int]]],
                      executed: Dict[str, Dict[str, Dict[str, int]]]
                      ) -> Dict[str, Any]:
    """Hold one executed train step's collectives (``executed``: label ->
    kind -> {"count", "bytes"}, as ``Mesh.collectives`` counts them on one
    rank) to the reckoning of the same step (``reck``: ``reckon``'s
    "by_label" for the same config, global batch, mesh shape and FSDP):
    every held label equal, FSDP's gathers half the reckoned, and the rest
    named departures with their bytes. Raises ``AssertionError`` on the
    first difference. Returns {"held": ..., "departures": {"reckoned":
    ..., "executed": ...}}."""
    known = set(HELD_LABELS + EXECUTED_ONLY) | {"fsdp-gather"}
    if set(executed) - known or set(reck) - known - set(RECKONED_ONLY):
        raise AssertionError(f"unknown labels: executed {sorted(executed)}, "
                             f"reckoned {sorted(reck)}")
    for label in HELD_LABELS:
        if executed.get(label, {}) != reck.get(label, {}):
            raise AssertionError(f"{label}: executed {executed.get(label)}, "
                                 f"reckoned {reck.get(label)}")
    once = {k: {"count": v["count"] // 2, "bytes": v["bytes"] // 2}
            for k, v in reck.get("fsdp-gather", {}).items()}
    twice = {k: {"count": 2 * v["count"], "bytes": 2 * v["bytes"]}
             for k, v in executed.get("fsdp-gather", {}).items()}
    if twice != reck.get("fsdp-gather", {}):
        raise AssertionError(f"fsdp-gather: executed "
                             f"{executed.get('fsdp-gather')}, reckoned "
                             f"{reck.get('fsdp-gather')} (two a leaf)")
    reckoned = {label: reck[label] for label in RECKONED_ONLY
                if label in reck}
    if once:
        reckoned["fsdp-gather (before the backward)"] = once
    return {"held": {label: reck[label] for label in HELD_LABELS
                     if label in reck},
            "departures": {
                "reckoned": reckoned,
                "executed": {label: executed[label] for label in EXECUTED_ONLY
                             if label in executed}}}


def _counted(scope: Scope, step) -> Fraction:
    """Run ``step()`` under the reckoning's scope, counting stand-in for
    the tensor-parallel sums, share rule and counters; returns its FLOPs
    (its bytes and collectives land in ``scope``)."""
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(common.reckoning(scope))
        ctx.enter_context(common.tensor_parallel(_CountingTP(scope)))
        ctx.enter_context(_share_blocks(scope))
        if not scope.train:
            ctx.enter_context(torch.no_grad())
        fc = ctx.enter_context(FlopCounterMode(
            display=False, custom_mapping=scope.flop_mapping()))
        ctx.enter_context(_ByteCounter(scope))
        step()
        return fc.get_total_flops()


def reckon_lisa_decode(pcfg: Any, mesh: Any, rows: int,
                       width: int) -> Dict[str, Any]:
    """One decode step of a LISA pipeline's LLM (``vlm.llm_decode_step``:
    ``rows`` rows, one token each, against a ``width``-slot cache) on
    ``mesh``, as ``reckon`` counts a zoo step: the LLM's embedding, layers
    and answer head cut by ``param_specs`` (the head by its "answer_head"
    rule), ``seg_proj`` whole. The sums are those that tensor-parallel
    serving (``sharding.serving``) runs over the same cut."""
    from repro_torch.core import vlm
    llm = pcfg.llm
    params = vlm.init_lisa(pcfg, torch.Generator(), device=META)
    view = {"embed": params["llm"]["embed"],
            "groups": params["llm"]["groups"],
            "head": params["llm"]["answer_head"]}
    scope, local, lcfg, _ = _local_step(llm, view, mesh, width=width)
    lparams = dict(params, llm=dict(params["llm"], embed=local["embed"],
                                    groups=local["groups"],
                                    answer_head=local["head"]))
    lpcfg = dataclasses.replace(pcfg, llm=lcfg)
    kv = (llm.num_layers, rows, width, lcfg.num_kv_heads,
          lcfg.resolved_head_dim)
    cache = {"groups": [{"k": _meta(kv, llm.adtype),
                         "v": _meta(kv, llm.adtype)}],
             "positions": _meta((rows, width), torch.int32)}
    tokens = _meta((rows, 1), torch.int32)
    flops = _counted(scope, lambda: vlm.llm_decode_step(
        lparams, lpcfg, cache, tokens, width - 1))
    return {"flops": float(flops), "bytes": float(scope.bytes),
            "collectives": dict(scope.collectives),
            "kinds": sorted(scope.plan.kinds), "attention": scope.plan.attn}


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

PEAK_FLOPS = H100_SXM.flops_per_sec       # dense bf16 FLOP/s (H100 SXM)
HBM_BW = H100_SXM.hbm_bytes_per_sec       # bytes/s
NVLINK_BW = 450e9                         # NVLink 4, bytes/s per direction


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n_active = stack.count_params(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # one token


def run_combo(arch: str, shape_name: str, multi_pod: bool,
              out_dir: str = OUT_DIR,
              cfg_override: Optional[ModelConfig] = None,
              tag: str = "", with_costs: Optional[bool] = None,
              fsdp: bool = False) -> Dict[str, Any]:
    # costs are a single-pod deliverable; the multi-pod pass proves the
    # "pod" axis shards (bytes only), as the reference's
    if with_costs is None:
        with_costs = not multi_pod
    shape = SHAPES[shape_name]
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    cfg = adapt_config(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "tag": tag, "fsdp": fsdp}
    if cfg is None:
        rec["skipped"] = ("encoder-only: no decode step"
                          if shape.kind == "decode" else "not applicable")
        _save(rec, out_dir)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    rec["n_chips"] = n_chips
    try:
        t0 = time.time()
        rec["device_bytes"] = device_bytes(cfg, shape, mesh, fsdp=fsdp)
        rec["bytes_s"] = round(time.time() - t0, 2)
        if not with_costs:
            _save(rec, out_dir)
            return rec
        t0 = time.time()
        rec.update(reckon(cfg, shape, mesh, fsdp=fsdp))
        rec["reckon_s"] = round(time.time() - t0, 2)
        mf = model_flops(cfg, shape)
        rec["model_flops"] = mf
        rec["compute_term_s"] = rec["flops"] / PEAK_FLOPS
        rec["memory_term_s"] = rec["bytes"] / HBM_BW
        rec["collective_term_s"] = rec["collectives"]["total"] / NVLINK_BW
        rec["useful_flops_ratio"] = (mf / n_chips) / max(rec["flops"], 1)
        terms = {"compute": rec["compute_term_s"],
                 "memory": rec["memory_term_s"],
                 "collective": rec["collective_term_s"]}
        rec["bottleneck"] = max(terms, key=terms.get)
    except Exception as e:                                    # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
    _save(rec, out_dir)
    return rec


def _save(rec: Dict[str, Any], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)


def status(rec: Dict[str, Any]) -> str:
    """The one-line summary ``main`` prints for a record."""
    if rec.get("skipped") or rec.get("error"):
        return rec.get("skipped") or rec.get("error")
    db = rec["device_bytes"]["total"]
    if "flops" in rec:
        return (f"ok flops={rec['flops']:.3g} bytes={rec['bytes']:.3g} "
                f"coll={rec['collectives']['total']:.3g} "
                f"bottleneck={rec['bottleneck']} device_bytes={db:.3g} "
                f"[reckon {rec['reckon_s']}s]")
    return f"ok (bytes only) device_bytes={db:.3g} [{rec['bytes_s']}s]"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_combo(arch, shape, mp, out_dir=args.out)
                print(f"[dryrun] {arch} x {shape} x "
                      f"{'2x16x16' if mp else '16x16'}: {status(rec)}",
                      flush=True)


if __name__ == "__main__":
    main()
