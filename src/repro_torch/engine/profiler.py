"""Device-level performance observability (port of
``repro/engine/profiler.py``): the stage profiler, compile observatory, and
cost/energy ledger.

The engine's metrics observe the mission-clock request lifecycle; this
module observes the device: where wall time, compiles, FLOPs and joules go,
per executor stage. One opt-in knob (``AveryEngine(profile=...)``, off by
default, nothing added when off) brings three instruments:

  * :class:`StageProfiler` wraps every executor stage entry point
    (:class:`ProfiledExecutor`) and the draft model
    (:class:`ProfiledDraft`). Each call is timed on the injected
    ``wallclock`` up to the end of its device work (``_block`` waits for
    the stream of every CUDA tensor among the stage's outputs) into
    per-(stage, tier, bucket) log-bucket histograms, kept in a bounded span
    ring, and exported as a device track (pid 3) into the engine's Perfetto
    ``dump_trace`` document. Wall time comes only from the engine's
    ``wallclock``; span placement from the mission clock.
  * :class:`CompileObservatory` diffs a census of what the port creates at
    serve time (``analysis.sanitizers.named_jit_roots``: the kernel
    libraries built and loaded, and on CUDA the caching allocator's device
    allocations) around each profiled call and records every event: stage,
    root label, wall time, count. A page pool that grows mid-flight shows
    up as an allocator event.
  * :class:`CloudCostModel` joins the analytic FLOPs / HBM-bytes models of
    ``network/energy.py`` with the cloud card's constants (the H100's
    unless a device is given) to attribute per-request compute cost (via
    the in-flight decoder's per-slot ledger) and an achieved-vs-roofline
    fraction for the paged LLM stages.

The ledger covers the paged LLM serving stages (the prefill on a prefix
miss, then every decode / verify token at its attended context length).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.streams import sync_window
from repro_torch.engine.observability import (DEVICE_TRACK_PID,
                                              FlightRecorder,
                                              MetricsRegistry)
from repro_torch.network.energy import (H100_SXM, decode_token_flops,
                                        decode_token_hbm_bytes,
                                        encoder_flops)

# the fixed stage vocabulary: stats() keys derive from this tuple so the
# profiled stats surface is deterministic whether or not a stage ran
PROFILED_STAGES = ("edge_context", "edge_insight", "cloud_sam_feats",
                   "cloud_prefix", "pool_write", "cloud_decode_rows",
                   "cloud_verify_rows", "cloud_mask", "draft_admit",
                   "draft")
# the stages whose ledger FLOPs/bytes the roofline fraction compares
# against measured wall time (the paged LLM path the cost model covers)
_LEDGER_STAGES = ("cloud_prefix", "cloud_decode_rows", "cloud_verify_rows")


def _cuda_devices(out: Any, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (nested tuples, lists
    and dicts)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def _block(out: Any, device: Any = None) -> None:
    """Wait for the stream of every CUDA tensor among a stage's outputs
    (and of ``device``, for a stage that returns none: the draft model's
    prefill), so the wall-time delta bounds the stage's device work, not
    its launches (the counterpart of ``block_until_ready``). numpy outputs
    are already copied and CPU tensors need no wait. The wait is an
    explicit sync, so it runs in the executor's explicit window."""
    found = set()
    if device is not None and torch.device(device).type == "cuda":
        found.add(torch.device(device))
    for device in _cuda_devices(out, found):
        with sync_window(device):
            torch.cuda.current_stream(device).synchronize()


class CloudCostModel:
    """Analytic per-stage cost of the paged LLM serving path on the cloud
    card: prefill FLOPs per admitted prefix, per-token decode FLOPs and HBM
    bytes at the row's attended context length, joules from the card's
    power. ``device`` (a ``CloudDevice``) defaults to the H100 SXM's
    constants."""

    def __init__(self, pcfg: Any, device: Optional[Any] = None):
        self.llm = pcfg.llm
        self.device = device if device is not None else H100_SXM

    def prefill_flops(self, prefix_len: int) -> float:
        return encoder_flops(self.llm, int(prefix_len))

    def token_flops(self, ctx_len: int) -> float:
        return decode_token_flops(self.llm, int(ctx_len))

    def token_hbm_bytes(self, ctx_len: int) -> float:
        return decode_token_hbm_bytes(self.llm, int(ctx_len))

    def energy_j(self, flops: float) -> float:
        return self.device.compute_energy_j(flops)


class CompileObservatory:
    """Records every compile event by diffing a census of the engine's
    labelled roots around each profiled stage call. The census is
    re-discovered each time (``named_jit_roots``), so a root that appears
    mid-flight (a kernel library loaded for the first time) is observed
    the first time it runs."""

    def __init__(self, max_events: int = 256,
                 flight: Optional[FlightRecorder] = None):
        self._roots_fn: Optional[Callable[[], Dict[str, Any]]] = None
        self._flight = flight
        self._last: Dict[str, int] = {}
        self.events: deque = deque(maxlen=int(max_events))
        self.n_compiles = 0
        self.n_events = 0
        self.compile_wall_s = 0.0

    def bind(self, roots_fn: Callable[[], Dict[str, Any]],
             flight: Optional[FlightRecorder] = None) -> None:
        self._roots_fn = roots_fn
        if flight is not None:
            self._flight = flight

    def census(self) -> Dict[str, int]:
        if self._roots_fn is None:
            return {}
        return {label: int(fn._cache_size())
                for label, fn in self._roots_fn().items()}

    def prime(self) -> None:
        """Take the baseline census without recording events (what exists
        already is not new)."""
        self._last = self.census()

    def note(self, stage: str, wall_s: float, t: float) -> None:
        """Diff the census after one profiled ``stage`` call; any growth is
        an event whose wall time is (conservatively) the whole call's."""
        for label, n in self.census().items():
            prev = self._last.get(label, 0)
            if n <= prev:
                self._last[label] = n
                continue
            delta = n - prev
            self._last[label] = n
            self.n_compiles += delta
            self.n_events += 1
            self.compile_wall_s += wall_s
            self.events.append({"stage": stage, "root": label,
                                "delta": delta, "wall_s": wall_s, "t": t})
            if self._flight is not None:
                self._flight.record("compile", t, data={
                    "stage": stage, "root": label, "delta": delta,
                    "wall_s": wall_s})

    @property
    def n_roots(self) -> int:
        return len(self._last)


class StageProfiler:
    """Per-stage device timing + compile observatory + cost ledger.

    Construct with the same injectable ``wallclock`` the engine uses
    (``AveryEngine(profile=True, wallclock=time.perf_counter)`` builds one
    for you), then the engine wraps its executor via :meth:`wrap` and binds
    the mission clock / census via :meth:`attach`. Every profiled call
    costs two wallclock reads, one wait for the stage's device work, a
    histogram bump and a census diff. ``device`` (a ``CloudDevice``) sets
    the roofline constants and the engine's cost model; by default the
    engine's cost model's (the H100's).
    """

    def __init__(self, wallclock: Callable[[], float],
                 max_spans: int = 2048, max_compile_events: int = 256,
                 device: Optional[Any] = None):
        if wallclock is None:
            raise ValueError(
                "StageProfiler needs an injected wallclock (engine code "
                "never reads the wall clock itself)")
        self._wallclock = wallclock
        self._clock: Callable[[], float] = lambda: 0.0
        self._device = device
        self.registry = MetricsRegistry()
        self.spans: deque = deque(maxlen=int(max_spans))
        self.observatory = CompileObservatory(
            max_events=max_compile_events)
        self.n_calls = 0
        self.wall_s = 0.0
        # the cost ledger: totals attributed to finished responses
        self.ledger_flops = 0.0
        self.ledger_hbm_bytes = 0.0
        self.ledger_energy_j = 0.0

    @property
    def device(self) -> Optional[Any]:
        """The cloud device given at construction (or bound by
        :meth:`attach`), or None."""
        return self._device

    # -- engine binding --

    def attach(self, engine: Any) -> None:
        """Bind the mission clock, the labelled census and the flight
        recorder. Called by the engine at construction; safe to call again
        (rebinds)."""
        self._clock = lambda: engine._now
        if self._device is None:
            cost = getattr(engine, "cost_model", None)
            if cost is not None:
                self._device = cost.device

        def roots() -> Dict[str, Any]:
            from repro_torch.analysis.sanitizers import named_jit_roots
            return named_jit_roots(engine)

        self.observatory.bind(roots, flight=getattr(engine, "flight",
                                                    None))
        self.observatory.prime()

    def wrap(self, executor: Any) -> "ProfiledExecutor":
        return ProfiledExecutor(executor, self)

    def wrap_draft(self, draft: Any) -> "ProfiledDraft":
        return ProfiledDraft(draft, self)

    # -- the timed call path --

    def _call(self, stage: str, fn: Callable, args: tuple, kwargs: dict,
              tier: Optional[str] = None, bucket: Optional[int] = None,
              device: Any = None) -> Any:
        w0 = self._wallclock()
        out = fn(*args, **kwargs)
        _block(out, device)
        dt = self._wallclock() - w0
        t = self._clock()
        self.n_calls += 1
        self.wall_s += dt
        self.registry.histogram(f"stage_s:{stage}").observe(dt)
        if tier is not None:
            self.registry.histogram(
                f"stage_s:{stage}:tier={tier}").observe(dt)
        if bucket is not None:
            self.registry.histogram(
                f"stage_s:{stage}:b{int(bucket)}").observe(dt)
        self.spans.append((stage, tier, bucket, t, dt))
        self.observatory.note(stage, dt, t)
        return out

    # -- the cost ledger --

    def note_ledger(self, flops: float, hbm_bytes: float,
                    energy_j: float) -> None:
        self.ledger_flops += flops
        self.ledger_hbm_bytes += hbm_bytes
        self.ledger_energy_j += energy_j

    # -- export --

    def chrome_events(self) -> List[Dict[str, Any]]:
        """The device track: pid 3, one thread per stage, one ``X`` span per
        profiled call. The mission clock does not advance during a
        synchronous drain, so same-stage spans are packed end to end from
        their mission timestamp (the durations are the data; the packing
        keeps the track readable and the timeline monotone)."""
        tids: Dict[str, int] = {}
        cursor: Dict[int, float] = {}
        events: List[Dict[str, Any]] = []
        for stage, tier, bucket, t, dt in self.spans:
            tid = tids.setdefault(stage, len(tids) + 1)
            ts = max(t * 1e6, cursor.get(tid, 0.0))
            dur = max(0.0, dt) * 1e6
            cursor[tid] = ts + dur
            args: Dict[str, Any] = {"stage": stage}
            if tier is not None:
                args["tier"] = tier
            if bucket is not None:
                args["bucket"] = int(bucket)
            events.append({"name": stage, "cat": "device", "ph": "X",
                           "pid": DEVICE_TRACK_PID, "tid": tid,
                           "ts": ts, "dur": dur, "args": args})
        for ev in self.observatory.events:
            tid = tids.setdefault(ev["stage"], len(tids) + 1)
            events.append({"name": f"compile:{ev['root']}",
                           "cat": "compile", "ph": "i", "s": "t",
                           "pid": DEVICE_TRACK_PID, "tid": tid,
                           "ts": ev["t"] * 1e6,
                           "args": {"root": ev["root"],
                                    "delta": ev["delta"],
                                    "wall_s": ev["wall_s"]}})
        meta: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": DEVICE_TRACK_PID,
             "tid": 0, "args": {"name": "device stages"}}]
        for stage in sorted(tids):
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": DEVICE_TRACK_PID, "tid": tids[stage],
                         "args": {"name": stage}})
        return meta + events

    def stats_block(self) -> Dict[str, float]:
        """The profiler's contribution to ``engine.stats``: a fixed key set
        (derived from :data:`PROFILED_STAGES`) whichever stages ran."""
        out: Dict[str, float] = {}
        measured_ledger_wall = 0.0
        for stage in PROFILED_STAGES:
            h = self.registry.histogram(f"stage_s:{stage}")
            out[f"stage_{stage}_calls"] = h.count
            out[f"stage_{stage}_p50_s"] = h.p50
            if stage in _LEDGER_STAGES:
                measured_ledger_wall += h.total
        out["profiled_stage_calls"] = self.n_calls
        out["profiled_wall_s"] = self.wall_s
        out["compile_events"] = self.observatory.n_compiles
        out["compile_wall_s"] = self.observatory.compile_wall_s
        out["compiled_roots"] = self.observatory.n_roots
        out["ledger_flops_total"] = self.ledger_flops
        out["ledger_hbm_bytes_total"] = self.ledger_hbm_bytes
        out["ledger_energy_j_total"] = self.ledger_energy_j
        frac = 0.0
        if self._device is not None and measured_ledger_wall > 0.0:
            frac = self._device.roofline_s(
                self.ledger_flops,
                self.ledger_hbm_bytes) / measured_ledger_wall
        out["decode_roofline_frac"] = frac
        return out


class ProfiledExecutor:
    """Executor wrapper that times every stage entry point through the
    profiler (the same ``_inner`` + ``__getattr__`` shape as
    ``FaultyExecutor``, so the sanitizers' census unwraps it)."""

    def __init__(self, inner: Any, profiler: StageProfiler):
        self._inner = inner
        self._profiler = profiler

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def edge_context(self, *a: Any, **kw: Any) -> Any:
        return self._profiler._call("edge_context",
                                    self._inner.edge_context, a, kw)

    def edge_insight(self, *a: Any, **kw: Any) -> Any:
        tier = kw.get("tier", a[1] if len(a) > 1 else None)
        return self._profiler._call(
            "edge_insight", self._inner.edge_insight, a, kw,
            tier=getattr(tier, "name", None))

    def cloud_sam_feats(self, *a: Any, **kw: Any) -> Any:
        pkt = kw.get("packet", a[0] if a else None)
        return self._profiler._call(
            "cloud_sam_feats", self._inner.cloud_sam_feats, a, kw,
            tier=getattr(pkt, "tier_name", None))

    def cloud_prefix(self, *a: Any, **kw: Any) -> Any:
        q = kw.get("query", a[1] if len(a) > 1 else None)
        qlen = None if q is None else int(q.shape[-1])
        return self._profiler._call("cloud_prefix",
                                    self._inner.cloud_prefix, a, kw,
                                    bucket=qlen)

    def pool_write(self, *a: Any, **kw: Any) -> Any:
        return self._profiler._call("pool_write",
                                    self._inner.pool_write, a, kw)

    def cloud_decode_rows(self, *a: Any, **kw: Any) -> Any:
        toks = kw.get("tokens", a[3] if len(a) > 3 else None)
        bucket = None if toks is None else int(toks.shape[0])
        return self._profiler._call(
            "cloud_decode_rows", self._inner.cloud_decode_rows, a, kw,
            bucket=bucket)

    def cloud_verify_rows(self, *a: Any, **kw: Any) -> Any:
        toks = kw.get("tokens", a[3] if len(a) > 3 else None)
        bucket = None if toks is None else int(toks.shape[0])
        return self._profiler._call(
            "cloud_verify_rows", self._inner.cloud_verify_rows, a, kw,
            bucket=bucket)

    def cloud_mask(self, *a: Any, **kw: Any) -> Any:
        return self._profiler._call("cloud_mask",
                                    self._inner.cloud_mask, a, kw)


class ProfiledDraft:
    """Draft-model wrapper timing ``admit`` (the draft prefill) and
    ``draft`` (the lockstep proposal steps) as profiler stages; everything
    else (``commit``/``release``/telemetry attributes) delegates."""

    def __init__(self, inner: Any, profiler: StageProfiler):
        self._inner = inner
        self._profiler = profiler

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def admit(self, *a: Any, **kw: Any) -> Any:
        return self._profiler._call("draft_admit", self._inner.admit,
                                    a, kw, device=self._inner.device)

    def draft(self, *a: Any, **kw: Any) -> Any:
        return self._profiler._call("draft", self._inner.draft, a, kw,
                                    device=self._inner.device)
