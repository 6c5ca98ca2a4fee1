"""Runtime sanitizers (port of ``repro/analysis/sanitizers.py``): the
budgets a static pass can't prove, measured on the live engine.

The reference counts the traces XLA compiled across its jit caches. The
eager port has no jit cache; what it does create at serve time, and what
churns when a shape does, is counted in its place. The census
(:func:`named_jit_roots`, under the reference's name, since the stage
profiler's compile observatory binds to it) has two kinds of entry:

  * ``kernels.<name>``: each CUDA kernel library loaded through
    ``kernels/_build.py`` (``_loaded``). Its first use builds it with
    ``nvcc`` and loads it with ``dlopen``: the port's only compile.
  * ``allocator.device_alloc``: on a CUDA executor, the caching
    allocator's device allocations (``torch.cuda.memory_stats``'s
    ``num_device_alloc``). In steady state the allocator reuses its
    blocks; a new ``cudaMalloc`` mid-flight means a buffer changed shape
    or grew, as a page pool that doubles does. This is the eager
    counterpart of shape churn.

On a CPU executor no kernel loads and there is no allocator to count, so
the census is empty. (``DualStreamExecutor.num_compiled_stages`` stays 0.)

  * :class:`RecompileSanitizer`: ``arm()`` after warmup snapshots the
    census total; ``check(budget=0)`` raises :class:`RecompileBudgetError`
    if steady state created anything new.
  * :func:`transfer_guard_ctx`: on a CUDA executor,
    ``torch.cuda.set_sync_debug_mode("error")`` for the guarded region,
    the previous mode restored on every exit. Any operation that
    synchronises the host with the card inside it raises. The executor's
    explicit stage-boundary copies (``core/streams.py``'s ``to_device`` /
    ``host``, which the draft model uses too) and the stage profiler's
    wait run inside the executor's explicit window
    (``core.streams.sync_window``), which permits their synchronisation:
    the reference's rule, under which explicit ``jnp.asarray`` /
    ``device_get`` stay allowed. On a CPU executor the guard is a no-op:
    host memory has no transfer to guard (and PyTorch without CUDA raises
    on ``set_sync_debug_mode``).

Both are engine knobs: ``AveryEngine(debug_recompiles=True)`` arms a
sanitizer the engine checks on every pump and drain after
``arm_sanitizers()``; ``debug_transfers=True`` wraps each decode pump and
drain in the guard. ``python -m repro_torch.analysis.sanitizers --smoke``
runs both against an in-flight engine on lisa-mini (on the card unless
``--device cpu``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.core.streams import NULL_CTX, SyncDebugMode, on_card
from repro_torch.kernels import _build


class RecompileBudgetError(AssertionError):
    """Steady-state decode compiled (or allocated) something new."""


def _unwrap(executor: Any) -> Any:
    """Chase wrappers (fault injectors, the stage profiler) down to the
    real executor."""
    seen = set()
    while id(executor) not in seen:
        seen.add(id(executor))
        inner = getattr(executor, "_inner", None)
        if inner is None:
            break
        executor = inner
    return executor


def executor_device(executor: Any) -> Optional[torch.device]:
    """The device the (unwrapped) executor serves on, or None."""
    device = getattr(_unwrap(executor), "device", None)
    return None if device is None else torch.device(device)


class _KernelLibrary:
    """A census root: one kernel library of ``kernels/_build.py``, 1 once
    it is built and loaded."""

    def __init__(self, name: str):
        self.name = name

    def _cache_size(self) -> int:
        return int(self.name in _build._loaded)


class _DeviceAllocations:
    """A census root: the caching allocator's device allocations so far
    on one CUDA device."""

    def __init__(self, device: torch.device):
        self.device = device

    def _cache_size(self) -> int:
        return int(torch.cuda.memory_stats(self.device)
                   .get("num_device_alloc", 0))


def named_jit_roots(engine: Any) -> "Dict[str, Any]":
    """What the port creates at serve time, labelled: ``kernels.<name>``
    for each loaded kernel library and, on a CUDA executor,
    ``allocator.device_alloc``. Each value has ``_cache_size()``, the
    count the census reads. Re-discovered on every count, so a library
    loaded after arming is counted: that is the point. The labels are what
    the compile observatory attributes compile events to."""
    roots: "Dict[str, Any]" = {f"kernels.{name}": _KernelLibrary(name)
                               for name in sorted(_build._loaded)}
    device = executor_device(getattr(engine, "executor", None))
    if on_card(device):
        roots["allocator.device_alloc"] = _DeviceAllocations(device)
    return roots


def jit_roots(engine: Any) -> List[Any]:
    """The engine's census roots, unlabelled (see :func:`named_jit_roots`)."""
    return list(named_jit_roots(engine).values())


class RecompileSanitizer:
    """Counts what the port created across the engine's census roots."""

    def __init__(self, engine: Any):
        self.engine = engine
        self.armed_at: "int | None" = None

    def compile_count(self) -> int:
        return sum(int(f._cache_size()) for f in jit_roots(self.engine))

    def arm(self) -> int:
        """Snapshot after warmup; subsequent growth is a violation."""
        self.armed_at = self.compile_count()
        return self.armed_at

    def new_compiles(self) -> int:
        if self.armed_at is None:
            return 0
        return self.compile_count() - self.armed_at

    def check(self, budget: int = 0) -> None:
        n = self.new_compiles()
        if n > budget:
            raise RecompileBudgetError(
                f"steady-state decode built or allocated {n} new "
                f"item(s) (budget {budget}): a kernel library loaded, or "
                "a buffer changed shape or grew")


def transfer_guard_ctx(enabled: bool = True, device: Any = "cuda"):
    """Raise on any host-card synchronisation in the region, on a CUDA
    ``device``; a no-op context when not ``enabled`` or on the CPU."""
    if not enabled or not on_card(device):
        return NULL_CTX
    return SyncDebugMode("error")


# ---------------------------------------------------------------------------
# smoke: both sanitizers against a real in-flight engine
# ---------------------------------------------------------------------------


def _smoke(device: str = "cuda") -> int:
    import numpy as np

    from repro_torch.configs.lisa_mini import CONFIG as PCFG
    from repro_torch.core import profile as prof
    from repro_torch.core.intent import Intent
    from repro_torch.core.lut import paper_lut
    from repro_torch.core.streams import DualStreamExecutor
    from repro_torch.data import floodseg
    from repro_torch.engine import AveryEngine
    from repro_torch.kernels.decode_attention import ops

    lut = paper_lut()
    params, bns, _ = prof.random_init_system(PCFG, lut=lut, device=device)
    # the paged decode attention runs its kernel (the reference's smoke
    # takes its plain path, which keeps the CPU run in interpret mode
    # short); kv_pages pre-sizes the pool and max_prefixes bounds the
    # prefix store: a pool that grows mid-decode allocates anew
    execu = DualStreamExecutor(pcfg=PCFG, params=params, bottlenecks=bns,
                               lut=lut, max_new_tokens=3,
                               flash_decode=True, device=device)
    engine = AveryEngine(lut=lut, executor=execu, batching="inflight",
                         max_batch=4, kv_pages=64, max_prefixes=8,
                         debug_recompiles=True, debug_transfers=True)

    rng = np.random.RandomState(7)

    def submit(k: int, sid: int, t: float) -> Any:
        kind = "any" if k % 3 == 2 else "segment"
        b = floodseg.make_batch(rng, 1, kind, augment=False)
        if kind == "any":
            pkt, _ = execu.edge_context(b["images"], sid, t)
            intent = Intent.CONTEXT
        else:
            pkt = execu.edge_insight(b["images"], lut.tiers[k % 2], sid, t)
            intent = Intent.INSIGHT
        return engine.submit_packet(pkt, b["query"], intent, time_s=t)

    # warmup: mixed-intent/mixed-tier traffic through every stage shape
    futs = [submit(i, i, float(i)) for i in range(6)]
    engine.drain()
    warm = engine.arm_sanitizers()

    # steady state: same shape mix; pump with the transfer guard live
    ops.paged_launches = 0
    futs = [submit(i, 100 + i, 100.0 + i) for i in range(6)]
    for _ in range(16):
        engine.pump()
    engine.drain()
    assert all(f.done() for f in futs)
    engine.check_sanitizers()           # raises on anything new
    print(f"[sanitizers] smoke ok on {device}: {warm} census count at "
          f"arm, 0 new in steady state, no sync outside the explicit "
          f"window; paged_decode_attention launches {ops.paged_launches}")
    return 0


def main(argv: "Iterable[str] | None" = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.sanitizers")
    ap.add_argument("--smoke", action="store_true",
                    help="run both sanitizers against a real in-flight "
                         "engine on lisa-mini")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(list(argv) if argv is not None else None)
    if args.smoke:
        return _smoke(args.device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
