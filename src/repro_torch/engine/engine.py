"""`AveryEngine` — the one front door to the AVERY system (port of
``repro/engine/engine.py``).

    engine  = AveryEngine(lut=lut, executor=execu,
                          transport=ChannelTransport.from_trace(trace),
                          policy=AdaptivePolicy())
    session = engine.session("operator-0")
    future  = session.submit(prompt="segment the stranded person",
                             images=frame, query=query, time_s=t)
    ...
    response = future.result()          # drives the engine to completion

Per submission the engine runs the paper's full per-frame pipeline:
Sense (``Transport.bandwidth``), Gate (intent classification), Evaluate/
Select (``ControlPolicy``), edge compute (the executor's ``edge_context``
/ ``edge_insight``, or the analytic Jetson model on the profiled mission
path), packet transmission (``Transport.send``), and cloud serving —
either closed tier-bucketed microbatches (``MicrobatchScheduler``) or the
token-level in-flight batch (``InflightDecoder``), where a request
submitted mid-decode joins the running batch between steps.

``OperatorSession`` carries per-operator context: mission goal, intent
requirements, prompt history, an optional per-UAV transport/policy
override, and the fidelity oracle for profiled missions.

The engine is host code: it touches the device only through the executor.
``profile=`` adds the stage profiler and cost ledger (``engine.profiler``);
``debug_recompiles=`` / ``debug_transfers=`` the runtime sanitizers
(``analysis.sanitizers``); ``mesh=`` tensor-parallel paged serving
(``sharding.serving``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.analysis.sanitizers import (RecompileSanitizer,
                                             executor_device,
                                             transfer_guard_ctx)
from repro_torch.configs import lisa_nano
from repro_torch.configs.lisa7b import CONFIG as LISA7B
from repro_torch.core import packets as pk
from repro_torch.core.controller import MissionGoal
from repro_torch.core.intent import (DEFAULT_REQUIREMENTS, Intent,
                               IntentRequirements, classify_intent)
from repro_torch.core.lut import SystemLUT
from repro_torch.core.paging import PagePool
from repro_torch.engine.api import Request, RequestFuture, Response
from repro_torch.engine.inflight import InflightDecoder
from repro_torch.engine.observability import (FlightRecorder,
                                              MetricsRegistry, Tracer)
from repro_torch.engine.policy import (AdaptivePolicy, ControlPolicy,
                                       RetryPolicy, TierDecision)
from repro_torch.engine.profiler import CloudCostModel, StageProfiler
from repro_torch.engine.scheduler import (QOS_CLASSES, FifoScheduler,
                                          qos_class)
from repro_torch.engine.speculative import SpecStats, SpeculativeConfig
from repro_torch.engine.transport import LoopbackTransport, Transport
from repro_torch.network.energy import (EdgeDevice, edge_insight_flops,
                                        encoder_flops, patch_embed_flops)
from repro_torch.runtime.scheduler import MicrobatchScheduler, ServeRequest

BATCHING_MODES = ("microbatch", "generate", "inflight")

# registry keys of the engine's terminal/telemetry counters; the
# ``stats()`` names and the legacy ``n_*`` attribute surface both read
# through these (see the properties on AveryEngine)
_COUNTER_KEYS = ("submitted", "completed", "infeasible", "blackouts",
                 "deadline_cancelled", "cloud_errors", "rejected",
                 "starved", "retries", "downshifts", "load_downshifts")


@dataclass
class OperatorSession:
    """Per-operator (or per-UAV) context riding on a shared engine."""
    engine: "AveryEngine"
    operator_id: str
    goal: MissionGoal = MissionGoal.PRIORITIZE_ACCURACY
    finetuned: bool = False
    requirements: Dict[Intent, IntentRequirements] = field(
        default_factory=lambda: dict(DEFAULT_REQUIREMENTS))
    # per-session overrides of the engine-level plug points (fleet: one
    # uplink share and one controller per UAV)
    transport: Optional[Transport] = None
    policy: Optional[ControlPolicy] = None
    oracle: Optional[Any] = None       # FidelityOracle for profiled frames
    # scheduling priority for every request on this session (a command
    # post outranks routine UAV telemetry); per-request override wins
    priority: int = 0
    history: List[tuple] = field(default_factory=list)

    def classify(self, prompt: str) -> Intent:
        return classify_intent(prompt)

    def submit(self, prompt: str = "", images: Any = None,
               query: Optional[np.ndarray] = None, time_s: float = 0.0,
               intent: Optional[Intent] = None,
               priority: Optional[int] = None) -> RequestFuture:
        """Full serving path: edge inference -> transport -> cloud batch."""
        return self.engine.submit(
            Request(prompt=prompt, intent=intent, images=images, query=query,
                    time_s=time_s,
                    priority=self.priority if priority is None
                    else int(priority)), self)

    def submit_frame(self, t: float,
                     intent: Intent = Intent.INSIGHT) -> Response:
        """Profiled mission frame: analytic edge model + LUT/oracle
        fidelity instead of device inference (the §5.3 simulator path)."""
        return self.engine.submit_frame(self, t, intent=intent)

    def close(self) -> int:
        """End this operator's mission: release their cached prefix
        pages from the engine's KV pool. Returns the number of prefix
        entries freed."""
        return self.engine.release_prefixes(self.operator_id)


class AveryEngine:
    """Owns the executor, LUT, scheduler/in-flight decoder, transports,
    policies, and telemetry; all entry points drive it, none wire it."""

    def __init__(self, lut: SystemLUT, executor: Any = None, *,
                 transport: Optional[Transport] = None,
                 policy: Optional[ControlPolicy] = None,
                 max_batch: int = 8, batching: str = "microbatch",
                 deploy: Any = None, edge_device: Optional[EdgeDevice] = None,
                 share_prefixes: bool = True,
                 kv_pages: Optional[int] = None,
                 max_prefixes: Optional[int] = None,
                 speculative: Any = None,
                 mesh: Any = None,
                 retry: Optional[RetryPolicy] = None,
                 scheduler: Any = None,
                 debug_invariants: bool = False,
                 debug_recompiles: bool = False,
                 debug_transfers: bool = False,
                 trace: Any = False,
                 flight_events: int = 256,
                 flight_dir: Optional[str] = None,
                 wallclock: Optional[Callable[[], float]] = None,
                 profile: Any = False):
        """``speculative`` (in-flight batching only): ``True`` enables
        Context-stream draft + paged multi-token verify with defaults,
        an int sets ``draft_tokens``, a ``SpeculativeConfig`` sets
        everything, and ``"nano"`` drafts with the truly-small
        ``lisa_nano`` geometry (the target's truncated trunk — see
        ``configs/lisa_nano``); the active ``ControlPolicy``'s
        ``allow_speculation`` gates drafting on the observed acceptance
        rate. ``max_prefixes`` LRU-caps the shared prefix store.
        ``retry`` (a ``RetryPolicy``) turns transmission blackouts and
        cloud-stage faults into bounded backoff-and-downshift retries
        instead of terminal failures; ``scheduler`` (``engine.scheduler``)
        plugs the admission policy — the default ``FifoScheduler``
        preserves strict arrival order; a ``QoSScheduler`` adds
        intent-aware classes, weighted-fair + strict-priority admission,
        per-operator rate limits, and preemption. The engine keeps the
        given instance as a prototype: rate buckets and telemetry are
        fleet-wide, each in-flight decoder gets a ``spawn()``.
        ``debug_invariants`` audits the KV pool
        (``PagePool.check_invariants``) after every pump/drain/
        cancellation — cheap, but meant for tests and chaos runs.

        Observability: ``trace`` (``True`` or a configured
        :class:`~repro_torch.engine.observability.Tracer`) records
        per-request mission-clock spans across the whole lifecycle,
        exportable with :meth:`dump_trace`; disabled (the default)
        every hook is a single branch. The metrics registry
        (``engine.metrics``) is always on — it backs the ``stats()``
        counters and the TTFT/queue-wait/transmit histograms. The
        flight recorder keeps the last ``flight_events`` engine events
        and, with ``flight_dir`` set, auto-dumps JSON when a request
        dies hard (terminal cloud error, deadline cancel) or the
        page-pool audit trips. ``wallclock`` injects a wall-time source
        (pass ``time.perf_counter``; engine code never reads the wall
        clock itself) to fill the decode/verify step histograms with the
        wall time of each ``cloud_decode_rows`` / ``cloud_verify_rows``
        call; on the card each call ends in a copy of its logits to the
        host, so the time includes the step's device work.

        ``debug_recompiles`` attaches a
        :class:`repro_torch.analysis.sanitizers.RecompileSanitizer`: call
        ``arm_sanitizers()`` after warmup and every later pump/drain
        raises ``RecompileBudgetError`` if steady state loaded a kernel
        library or made a new device allocation. ``debug_transfers``
        wraps each in-flight decode pump/drain in the transfer guard
        (``torch.cuda.set_sync_debug_mode("error")`` on a CUDA executor):
        any host-card synchronisation on the decode path outside the
        executor's explicit boundary copies raises.

        ``profile`` (``True`` or a configured
        :class:`~repro_torch.engine.profiler.StageProfiler`) adds
        device-level observability: every executor stage call is timed to
        the end of its device work into per-(stage, tier, bucket)
        histograms, compile events are recorded per census root (the
        compile observatory), per-request FLOPs/HBM-bytes/joules ride the
        responses (the cost ledger, on the profiler's cloud device, by
        default the H100's), and ``dump_trace`` gains a device track
        (pid 3). Off by default; ``profile=True`` requires ``wallclock``.

        ``mesh`` (a ``launch.mesh.make_local_mesh``, in-flight batching
        only) wraps the executor in a
        :class:`~repro_torch.sharding.serving.ShardedServingContext`: the
        paged prefill, decode and verify stages and the draft model run
        tensor-parallel over the mesh's "model" axis, and the KV pool holds
        this rank's kv heads. Every rank of the mesh drives its own engine
        on the same submissions; ``stats()`` gains ``mesh_devices`` and
        ``model_shards``."""
        if batching not in BATCHING_MODES:
            raise ValueError(f"batching must be one of {BATCHING_MODES}")
        self.lut = lut
        if mesh is not None:
            if executor is None:
                raise ValueError(
                    "mesh= sharded serving needs an executor to wrap")
            if batching != "inflight":
                # only the paged in-flight stages run sharded; a
                # microbatch/generate engine would silently serve
                # unsharded while reporting mesh telemetry
                raise ValueError(
                    "mesh= shards the paged in-flight serving stack; "
                    "construct the engine with batching='inflight'")
            from repro_torch.sharding.serving import ShardedServingContext
            if not isinstance(executor, ShardedServingContext):
                executor = ShardedServingContext(executor, mesh)
        self.mesh = mesh
        # device-level profiling: resolve the knob, then wrap the executor
        # so every stage call is timed (the wrap sits outermost, the mesh
        # context and fault injectors included)
        self.profiler = self._resolve_profiler(profile, wallclock)
        self.cost_model = None
        if self.profiler is not None:
            pcfg = getattr(executor, "pcfg", None)
            if pcfg is not None:
                self.cost_model = CloudCostModel(pcfg,
                                                 device=self.profiler.device)
            if executor is not None:
                executor = self.profiler.wrap(executor)
        self.executor = executor
        self.transport: Transport = transport or LoopbackTransport()
        self.policy: ControlPolicy = policy or AdaptivePolicy()
        self.batching = batching
        self.max_batch = max_batch
        self.edge_device = edge_device or EdgeDevice()
        self._deploy = deploy
        self._scheduler = None
        if executor is not None and batching in ("microbatch", "generate"):
            self._scheduler = MicrobatchScheduler(
                executor=executor, max_batch=max_batch,
                generate=(batching == "generate"))
        # one paged KV pool shared by every in-flight decoder: prefix
        # pages cached for one qlen survive that decoder's retirement
        self.kv_pool = PagePool(
            page_size=getattr(executor, "page_size", 16),
            share_prefixes=share_prefixes, initial_pages=kv_pages,
            max_prefixes=max_prefixes,
            placement=getattr(executor, "place_pool", None),
            shards=getattr(executor, "model_shards", 1))
        self.spec_config = self._resolve_speculative(speculative)
        if self.spec_config is not None and batching != "inflight":
            raise ValueError(
                "speculative decoding rides the in-flight batch; "
                "construct the engine with batching='inflight'")
        # draft prefill rows shared across decoders, like kv_pool: a
        # repeat-prefix frame after a drain skips the draft prefill too
        self._draft_prefix_rows: Dict = {}
        self._inflight: Dict[int, InflightDecoder] = {}   # qlen -> decoder
        self._retired_inflight = (0, 0)   # (steps, slot-steps) of evicted
        self._retired_faults = (0, 0)     # (cancels, stage faults) of evicted
        self._retired_spec = SpecStats()  # spec telemetry of evicted
        self._futures: Dict[int, RequestFuture] = {}
        self._order: List[int] = []
        self._seq = 0
        self.sessions: List[OperatorSession] = []
        self.retry = retry
        self.scheduler_proto = scheduler if scheduler is not None \
            else FifoScheduler()
        self.debug_invariants = debug_invariants
        self.debug_transfers = debug_transfers
        self._recompile_sanitizer = None
        if debug_recompiles:
            self._recompile_sanitizer = RecompileSanitizer(self)
        # mission-clock watermark: the latest time the engine has seen
        # (submissions, deliveries, retry backoffs). Deadline sweeps
        # cancel in-flight requests the watermark has passed.
        self._now = 0.0
        # observability: tracer (off by default — one branch per hook),
        # metrics registry (always on; backs the terminal counters and
        # the latency histograms), flight recorder (bounded event ring,
        # auto-dumps into flight_dir on hard failures). Terminal
        # outcomes are mutually exclusive: every submitted request
        # lands in exactly one of {completed, infeasible, blackouts,
        # deadline_cancelled, cloud_errors, rejected}; "starved"
        # separately counts *served* best-effort responses with
        # feasible=False (those also count as completed).
        self.tracer = trace if isinstance(trace, Tracer) \
            else Tracer(enabled=bool(trace))
        self.metrics = MetricsRegistry()
        self.flight = FlightRecorder(capacity=flight_events,
                                     autodump_dir=flight_dir)
        self._wallclock = wallclock
        self._counters = {key: self.metrics.counter(key)
                          for key in _COUNTER_KEYS}
        self.served_by_operator: Dict[str, int] = {}
        bind = getattr(self.scheduler_proto, "bind_metrics", None)
        if bind is not None:
            bind(self.metrics)
        if self.profiler is not None:
            # bind the mission clock, census and flight recorder now that
            # they all exist
            self.profiler.attach(self)

    @staticmethod
    def _resolve_profiler(profile: Any, wallclock):
        if isinstance(profile, StageProfiler):
            return profile
        if not profile:
            return None
        if wallclock is None:
            raise ValueError(
                "profile=True needs wallclock= (the profiler measures "
                "wall seconds; engine code never reads the wall clock "
                "itself: pass time.perf_counter)")
        return StageProfiler(wallclock)

    # ---- counters (registry-backed; n_* is the legacy read surface) ----

    def _bump(self, key: str, n: int = 1) -> None:
        self._counters[key].inc(n)

    @property
    def n_submitted(self) -> int:
        return self._counters["submitted"].value

    @property
    def n_completed(self) -> int:
        return self._counters["completed"].value

    @property
    def n_infeasible(self) -> int:
        return self._counters["infeasible"].value

    @property
    def n_blackouts(self) -> int:
        return self._counters["blackouts"].value

    @property
    def n_deadline(self) -> int:
        return self._counters["deadline_cancelled"].value

    @property
    def n_cloud_errors(self) -> int:
        return self._counters["cloud_errors"].value

    @property
    def n_rejected(self) -> int:
        return self._counters["rejected"].value

    @property
    def n_starved(self) -> int:
        return self._counters["starved"].value

    @property
    def n_retries(self) -> int:
        return self._counters["retries"].value

    @property
    def n_downshifts(self) -> int:
        return self._counters["downshifts"].value

    @property
    def n_load_downshifts(self) -> int:
        return self._counters["load_downshifts"].value

    def _resolve_speculative(self, speculative: Any
                             ) -> Optional[SpeculativeConfig]:
        if speculative is None or speculative is False:
            return None
        if speculative is True:
            return SpeculativeConfig()
        if isinstance(speculative, str):
            if speculative != "nano":
                raise ValueError(
                    f"unknown speculative mode {speculative!r}; the only "
                    f"named mode is 'nano'")
            if self.executor is None:
                raise ValueError(
                    "speculative='nano' slices its draft from the "
                    "executor's weights; construct the engine with one")
            return SpeculativeConfig(
                draft_pcfg=lisa_nano.CONFIG,
                draft_params=lisa_nano.nano_draft_params(
                    self.executor.params))
        if isinstance(speculative, int):
            return SpeculativeConfig(draft_tokens=speculative)
        if isinstance(speculative, SpeculativeConfig):
            return speculative
        raise ValueError(
            f"speculative must be bool, int, str, or SpeculativeConfig, "
            f"got {speculative!r}")

    def _merged_spec_stats(self) -> SpecStats:
        """Engine-lifetime speculation telemetry: retired decoders'
        counters plus every live decoder's."""
        spec = SpecStats()
        spec.merge(self._retired_spec)
        for d in self._inflight.values():
            spec.merge(d.spec_stats)
        return spec

    def _spec_gate(self, stats: SpecStats) -> bool:
        """The policy's drafting gate. Decided on the *engine-lifetime*
        acceptance stats, not the calling decoder's own (``stats``) —
        decoders retire on every ``drain`` and a per-burst view would
        re-enable a drafting scheme the floor already rejected, re-
        paying the warm-up waste each burst. Policies without the hook
        leave drafting on."""
        allow = getattr(self.policy, "allow_speculation", None)
        if allow is None:
            return True
        return bool(allow(self._merged_spec_stats(), self.spec_config))

    # ---- sessions ----

    def session(self, operator_id: Optional[str] = None, **kwargs: Any
                ) -> OperatorSession:
        if operator_id is None:
            operator_id = f"operator-{len(self.sessions)}"
        sess = OperatorSession(engine=self, operator_id=operator_id, **kwargs)
        self.sessions.append(sess)
        return sess

    @property
    def deploy(self):
        if self._deploy is None:
            self._deploy = LISA7B
        return self._deploy

    def bind_deploy(self, deploy: Any) -> None:
        """Pin the edge deployment geometry on a shared engine; rejects a
        conflicting rebind instead of silently using the wrong one."""
        if deploy is None:
            return
        if self._deploy is not None and self._deploy is not deploy:
            raise ValueError(
                "engine already bound to a different deploy geometry")
        self._deploy = deploy

    # ---- the shared Sense/Gate/Select front ----

    def _decide(self, session: OperatorSession, intent: Intent, t: float
                ) -> tuple:
        transport = session.transport or self.transport
        policy = session.policy or self.policy
        bw = transport.bandwidth(t)
        decision = policy.select(bw, intent, session.requirements[intent],
                                 self.lut, goal=session.goal,
                                 finetuned=session.finetuned)
        return transport, decision, bw

    # ---- full serving path ----

    def _register(self, request: Request, session: OperatorSession
                  ) -> RequestFuture:
        """Shared bookkeeping for every serving entry point."""
        request.request_id, self._seq = self._seq, self._seq + 1
        request.operator_id = session.operator_id
        fut = RequestFuture(request, self)
        self._futures[request.request_id] = fut
        self._order.append(request.request_id)
        self._bump("submitted")
        if self.tracer.enabled:
            self.tracer.begin(
                request.request_id, request.operator_id,
                intent=request.intent.name if request.intent else "",
                t=request.time_s)
        return fut

    def _deadline_for(self, session: OperatorSession, intent: Intent,
                      t: float) -> Optional[float]:
        max_latency = session.requirements[intent].max_latency_s
        return None if max_latency is None else t + max_latency

    def submit(self, request: Request, session: OperatorSession
               ) -> RequestFuture:
        if self.executor is None:      # before any bookkeeping: a raise
            raise RuntimeError(        # must not leave a ghost request
                "this engine has no executor; real submissions need one "
                "(profiled missions go through session.submit_frame)")
        intent = request.intent
        if intent is None:
            intent = request.intent = session.classify(request.prompt)
        session.history.append((request.time_s, request.prompt, intent))
        fut = self._register(request, session)
        fut.meta["session"] = session
        fut.meta["deadline"] = self._deadline_for(session, intent,
                                                  request.time_s)
        self._advance(request.time_s)
        if self._reject_overload(fut, session, request.time_s):
            return fut
        self._attempt(fut, request.time_s)
        self._sweep_deadlines()
        return fut

    def _reject_overload(self, fut: RequestFuture,
                         session: OperatorSession, t: float) -> bool:
        """Admission control at the front door: an operator over its
        rate limit is shed *before* any edge compute or transmission —
        the cheapest possible rejection. Resolves the future with
        ``failure="rejected"`` and returns True when shed."""
        reason = self.scheduler_proto.admission_check(
            session.operator_id, t)
        if reason is None:
            return False
        self._bump("rejected")
        fut.emit("rejected", t, reason=reason)
        fut.set_result(Response(
            request_id=fut.request.request_id,
            operator_id=session.operator_id, intent=fut.request.intent,
            feasible=False, failure="rejected",
            attempts=max(1, fut.attempts), t_submit=t, t_delivered=t,
            t_finished=self._now))
        return True

    # ---- attempts, retries, failures ----

    def _attempt(self, fut: RequestFuture, t: float,
                 prev_tier: Any = None) -> None:
        """One full serving attempt at mission time ``t``: Sense/Select
        (downshifted below ``prev_tier`` on a retry), edge (re-)encode at
        the chosen tier, transmit, enqueue on the cloud. Failures route
        through ``_send_failed`` which retries or resolves."""
        request = fut.request
        session: OperatorSession = fut.meta["session"]
        intent = request.intent
        transport, decision, bw = self._decide(session, intent, t)
        decision = self._adapt_to_load(session, decision, bw)
        if prev_tier is not None and self.retry is not None:
            decision = self.retry.downshifted(decision, prev_tier, self.lut,
                                              bw)
            if (decision.tier is not None
                    and decision.tier.payload_mb < prev_tier.payload_mb):
                self._bump("downshifts")
        fut.attempts += 1
        fut.emit("tier_selected", t, bandwidth_mbps=bw,
                 tier=decision.tier.name if decision.tier else None,
                 feasible=decision.feasible, attempt=fut.attempts)
        if decision.stream == "insight" and decision.tier is None:
            self._bump("infeasible")
            fut.emit("infeasible", t)
            fut.set_result(Response(
                request_id=request.request_id,
                operator_id=session.operator_id, intent=intent,
                feasible=False, failure="infeasible",
                attempts=max(1, fut.attempts), t_submit=request.time_s,
                t_delivered=t))
            return
        if intent is Intent.CONTEXT:
            packet, _ = self.executor.edge_context(
                request.images, request.request_id, t)
        else:
            packet = self.executor.edge_insight(
                request.images, decision.tier, request.request_id, t)
        if self.tracer.enabled:
            self.tracer.span(request.request_id, "edge_encode", t, t,
                             tier=decision.tier.name if decision.tier
                             else None)
        rec = transport.send(packet, t)
        self._advance(rec.end_s)
        if not rec.delivered:            # uplink blackout / drop
            self._send_failed(fut, decision, rec)
            return
        self._note_transmit(fut, packet, decision, rec)
        self._enqueue_cloud(fut, packet, request.query, decision, rec)

    def _adapt_to_load(self, session: OperatorSession,
                       decision: TierDecision, bw: float) -> TierDecision:
        """Scheduler feedback as a self-awareness input: policies with
        an ``adapt_to_load`` hook see the live queue pressure and may
        trade fidelity for admission latency (AdaptivePolicy downshifts
        the Insight tier under deep backlogs; Static never adapts; see
        engine/policy.py — the same optional-hook pattern as the
        speculation gate)."""
        policy = session.policy or self.policy
        hook = getattr(policy, "adapt_to_load", None)
        if hook is None or self.batching != "inflight":
            return decision
        adapted = hook(decision, self.scheduler_proto.load(), self.lut, bw)
        if (adapted.tier is not None and decision.tier is not None
                and adapted.tier.payload_mb < decision.tier.payload_mb):
            self._bump("load_downshifts")
        return adapted

    def _note_transmit(self, fut: RequestFuture, packet: pk.Packet,
                       decision: TierDecision, rec: Any) -> None:
        """Delivered-packet telemetry shared by both attempt paths: the
        ``transmitted`` stream event, the transmit-latency histograms
        (global + per tier), and the trace's transmit span."""
        fut.emit("transmitted", rec.end_s, payload_mb=packet.payload_mb)
        dt = max(0.0, rec.end_s - rec.start_s)
        tier = decision.tier.name if decision.tier else "context"
        self.metrics.histogram("transmit_s").observe(dt)
        self.metrics.histogram(f"transmit_s:tier={tier}").observe(dt)
        if self.tracer.enabled:
            self.tracer.span(fut.request.request_id, "transmit",
                             rec.start_s, rec.end_s,
                             payload_mb=packet.payload_mb, tier=tier)

    def _observe_event(self, request: Request, kind: str, t: float,
                       data: Dict[str, Any]) -> None:
        """Every ``RequestFuture.emit`` lands here: the flight recorder
        sees all lifecycle events; the tracer records the ones that are
        not already covered by a span (transmit/queue)."""
        self.flight.record(kind, t, request_id=request.request_id,
                           data=data)
        if self.tracer.enabled and kind not in ("transmitted", "queued"):
            self.tracer.point(request.request_id, kind, t, **data)

    def _attempt_packet(self, fut: RequestFuture, t: float) -> None:
        """Retry path for pre-encoded submissions: re-send the same
        packet (no images to re-encode means no tier downshift)."""
        session: OperatorSession = fut.meta["session"]
        transport = session.transport or self.transport
        packet: pk.Packet = fut.meta["fixed_packet"]
        decision: TierDecision = fut.meta["decision"]
        fut.attempts += 1
        rec = transport.send(packet, t)
        self._advance(rec.end_s)
        if not rec.delivered:
            self._send_failed(fut, decision, rec)
            return
        self._note_transmit(fut, packet, decision, rec)
        self._enqueue_cloud(fut, packet, fut.request.query, decision, rec)

    def _send_failed(self, fut: RequestFuture, decision: TierDecision,
                     rec: Any) -> None:
        """The transport gave up on the packet (bandwidth blackout or a
        drop). With a ``RetryPolicy`` and budget left — attempts below
        the cap, deadline not yet passed at the backed-off retry time —
        the engine retries; otherwise the request resolves as a failed
        delivery (no cloud work) so the caller can react instead of
        hanging."""
        fut.emit("blackout", rec.end_s)
        fut.meta.update(decision=decision, rec=rec)
        if self._can_retry(fut, rec.end_s):
            self._retry(fut, rec.end_s, decision.tier)
            return
        self._bump("blackouts")
        fut.set_result(self._base_response(fut, feasible=False,
                                           failure="blackout"))

    def _cloud_failed(self, fut: RequestFuture, out: Dict[str, Any]) -> None:
        """A cloud serving stage died under this request (the in-flight
        decoder already released its pages). Retry — back through edge
        encode and the transport, downshifted — or resolve failed."""
        decision: TierDecision = fut.meta["decision"]
        t_fail = max(self._now, fut.meta["rec"].end_s)
        fut.emit("cloud_error", t_fail, error=out.get("error", ""))
        if self._can_retry(fut, t_fail):
            self._retry(fut, t_fail, decision.tier)
            return
        self._bump("cloud_errors")
        fut.set_result(self._base_response(fut, feasible=False,
                                           failure="cloud_error"))
        self.flight.dump("cloud_error", stats=self.stats)

    def _can_retry(self, fut: RequestFuture, t_fail: float) -> bool:
        if self.retry is None or fut.attempts >= self.retry.max_attempts:
            return False
        deadline = fut.meta.get("deadline")
        t_retry = t_fail + self.retry.backoff_s(fut.attempts)
        return deadline is None or t_retry < deadline

    def _retry(self, fut: RequestFuture, t_fail: float,
               prev_tier: Any) -> None:
        t = t_fail + self.retry.backoff_s(fut.attempts)
        self._bump("retries")
        fut.emit("retry", t, attempt=fut.attempts + 1)
        self._advance(t)
        if fut.meta.get("fixed_packet") is not None:
            self._attempt_packet(fut, t)
        else:
            self._attempt(fut, t, prev_tier=prev_tier)

    # ---- deadlines (IntentRequirements.max_latency_s) ----

    def _advance(self, t: float) -> None:
        if t > self._now:
            self._now = t

    def _sweep_deadlines(self) -> None:
        """Cancel every unresolved request whose deadline the mission
        clock has passed: remove it from its decoder (slot + pages
        released refcount-safely) and resolve its future with a
        ``deadline`` failure, so ``result()`` never hangs on it."""
        for fut in list(self._futures.values()):
            if fut.done():
                continue
            deadline = fut.meta.get("deadline")
            if deadline is None or self._now < deadline:
                continue
            self._cancel_request(fut, deadline)

    def _cancel_request(self, fut: RequestFuture, deadline: float) -> None:
        rid = fut.request.request_id
        for dec in self._inflight.values():
            if dec.cancel(rid):
                break
        self._bump("deadline_cancelled")
        fut.emit("cancelled", deadline, reason="deadline")
        fut.set_result(self._base_response(fut, feasible=False,
                                           failure="deadline"))
        self.flight.dump("deadline_cancel", stats=self.stats)
        if self.debug_invariants:
            self._audit_pool()

    def submit_packet(self, packet: pk.Packet, query, intent: Intent,
                      time_s: float = 0.0,
                      session: Optional[OperatorSession] = None,
                      priority: Optional[int] = None) -> RequestFuture:
        """Low-level entry: serve an already-encoded packet (benchmarks
        and tests that prepare edge payloads out of band)."""
        if self.executor is None:
            raise RuntimeError(
                "this engine has no executor; real submissions need one "
                "(profiled missions go through session.submit_frame)")
        session = session or (self.sessions[0] if self.sessions
                              else self.session("_direct"))
        fut = self._register(Request(intent=intent, query=np.asarray(query),
                                     time_s=time_s,
                                     priority=session.priority
                                     if priority is None
                                     else int(priority)), session)
        decision = TierDecision(
            stream=packet.kind,
            tier=self.lut.by_name(packet.tier_name) if packet.tier_name
            else None)
        fut.meta.update(session=session, fixed_packet=packet,
                        decision=decision,
                        deadline=self._deadline_for(session, intent, time_s))
        self._advance(time_s)
        if self._reject_overload(fut, session, time_s):
            return fut
        self._attempt_packet(fut, time_s)
        self._sweep_deadlines()
        return fut

    # ---- cloud dispatch: closed microbatches or the in-flight batch ----

    def _enqueue_cloud(self, fut: RequestFuture, packet: pk.Packet, query,
                       decision: TierDecision, rec: Any) -> None:
        fut.meta.update(decision=decision, rec=rec)
        rid = fut.request.request_id
        if self.batching == "inflight":
            qlen = int(np.asarray(query).shape[-1])
            dec = self._inflight.get(qlen)
            if dec is None:
                dec = self._inflight[qlen] = InflightDecoder(
                    self.executor, slots=self.max_batch, pool=self.kv_pool,
                    spec=self.spec_config, spec_gate=self._spec_gate,
                    spec_prefix_rows=self._draft_prefix_rows,
                    scheduler=self.scheduler_proto.spawn(),
                    clock=lambda: self._now,
                    tracer=self.tracer, metrics=self.metrics,
                    wallclock=self._wallclock,
                    profiler=self.profiler, cost=self.cost_model)
            dec.submit(rid, fut.request.intent, packet, query,
                       on_done=self._resolve_inflight,
                       operator_id=fut.request.operator_id,
                       priority=fut.request.priority,
                       deadline=fut.meta.get("deadline"),
                       t_submit=rec.end_s)
            if fut.done():           # shed at enqueue (bounded queue)
                return
            # actual admission may happen steps later if slots are full;
            # the decoder stamps the real join point on the response
            fut.emit("queued", rec.end_s)
            dec.pump(1)              # keep the batch running between submits
            return
        self._scheduler.submit(ServeRequest(
            seq_id=rid, intent=fut.request.intent, packet=packet,
            query=np.asarray(query), arrival_s=fut.request.time_s))
        for res in self._scheduler.step_ready():
            self._resolve_scheduled(res)

    def _base_response(self, fut: RequestFuture, **kw: Any) -> Response:
        rec = fut.meta["rec"]
        decision: TierDecision = fut.meta["decision"]
        return Response(
            request_id=fut.request.request_id,
            operator_id=fut.request.operator_id,
            intent=fut.request.intent,
            tier_name=decision.tier.name if decision.tier else None,
            feasible=kw.pop("feasible", decision.feasible),
            failure=kw.pop("failure", None),
            attempts=max(1, fut.attempts),
            t_submit=fut.request.time_s,
            t_delivered=rec.end_s, **kw)

    def _resolve_scheduled(self, res: Any) -> None:
        fut = self._futures[res.seq_id]
        if fut.done():          # e.g. already cancelled past its deadline
            return
        fut.emit("served", fut.meta["rec"].end_s, batch_size=res.batch_size)
        resp = self._base_response(
            fut, answer_logits=res.answer_logits,
            mask_logits=res.mask_logits, tokens=res.tokens,
            batch_size=res.batch_size)
        resp.t_finished = self._now
        fut.set_result(resp)
        self._bump("completed")
        self._note_served(fut.request.operator_id)
        if not resp.feasible:
            self._bump("starved")        # served best-effort, F_I unmet

    def _resolve_inflight(self, out: Dict[str, Any]) -> None:
        fut = self._futures[out["seq_id"]]
        if fut.done():          # e.g. already cancelled past its deadline
            return
        failure = out.get("failure")
        if failure == "cloud_error":
            self._cloud_failed(fut, out)
            return
        if failure == "deadline":
            # the decoder's pre-admission sweep: expired while pending,
            # resolved without paying the prefill
            self._bump("deadline_cancelled")
            fut.emit("cancelled", self._now, reason="deadline")
            fut.set_result(self._base_response(
                fut, feasible=False, failure="deadline",
                t_finished=self._now))
            self.flight.dump("deadline_cancel", stats=self.stats)
            return
        if failure == "rejected":
            # shed at enqueue: the scheduler's bounded queue is full
            self._bump("rejected")
            fut.emit("rejected", self._now, reason=out.get("reason", ""))
            fut.set_result(self._base_response(
                fut, feasible=False, failure="rejected",
                t_finished=self._now))
            return
        fut.emit("served", fut.meta["rec"].end_s,
                 joined_step=out["joined_step"],
                 prefix_hit=out["prefix_hit"])
        resp = self._base_response(
            fut, answer_logits=out["answer_logits"],
            mask_logits=out["mask_logits"], tokens=out["tokens"],
            batch_size=out["batch_size"])
        flops = out.get("cloud_flops")
        if flops is not None:
            # the cost ledger (profiled engines only): analytic
            # FLOPs/HBM-bytes accumulated per slot by the decoder, joules
            # from the cloud device's power
            resp.cloud_flops = flops
            resp.cloud_hbm_bytes = out.get("cloud_hbm_bytes", 0.0)
            if self.cost_model is not None:
                resp.cloud_energy_j = self.cost_model.energy_j(flops)
            if self.profiler is not None:
                self.profiler.note_ledger(
                    resp.cloud_flops, resp.cloud_hbm_bytes or 0.0,
                    resp.cloud_energy_j or 0.0)
        resp.joined_step = out["joined_step"]
        resp.prefix_hit = out["prefix_hit"]
        resp.speculative = out.get("speculative")
        resp.preemptions = out.get("preemptions", 0)
        resp.queue_wait_s = out.get("queue_wait")
        resp.t_finished = self._now
        tft = out.get("t_first_token")
        if tft is not None:
            resp.ttft_s = max(0.0, tft - fut.request.time_s)
        self._observe_served(fut, resp)
        fut.set_result(resp)
        self._bump("completed")
        self._note_served(fut.request.operator_id)
        if not resp.feasible:
            self._bump("starved")        # served best-effort, F_I unmet

    def _observe_served(self, fut: RequestFuture, resp: Response) -> None:
        """Per-QoS-class serving histograms (in-flight path): TTFT,
        queue wait, and end-to-end token throughput."""
        cls = qos_class(fut.request.intent)
        if resp.ttft_s is not None:
            self.metrics.histogram(f"ttft_s:{cls}").observe(resp.ttft_s)
        if resp.queue_wait_s is not None:
            self.metrics.histogram(f"queue_wait_s:{cls}").observe(
                resp.queue_wait_s)
        if resp.tokens is not None and resp.t_finished is not None:
            dur = resp.t_finished - fut.request.time_s
            if dur > 0.0:
                n_tok = int(np.asarray(resp.tokens).shape[-1])
                self.metrics.histogram(f"tokens_per_s:{cls}",
                                       hi=1e6).observe(n_tok / dur)

    def _note_served(self, operator_id: str) -> None:
        self.served_by_operator[operator_id] = \
            self.served_by_operator.get(operator_id, 0) + 1

    def pump(self) -> None:
        """Advance cloud serving without waiting: serve any full
        microbatches, or one in-flight decode step per live decoder.
        Sweeps deadlines first — an overdue request must not consume a
        decode step it can no longer use."""
        self._sweep_deadlines()
        if self._scheduler is not None:
            for res in self._scheduler.step_ready():
                self._resolve_scheduled(res)
        with self._transfer_guard():
            for dec in self._inflight.values():
                dec.pump(1)
        if self.tracer.enabled:
            load = self.scheduler_proto.load()
            for key in sorted(load):
                self.metrics.gauge(key).set(load[key])
        if self.debug_invariants:
            self._audit_pool()
        self.check_sanitizers()

    def drain(self, release_operator: Optional[str] = None
              ) -> List[Response]:
        """Serve everything outstanding. Returns the responses delivered
        since the last drain, in submission order — delivered requests
        are evicted from the engine's tables (their ``RequestFuture``
        keeps the response), so a submit/drain/submit stream neither
        re-returns history nor accumulates served payloads.

        Cached prefix pages survive the drain (cross-burst reuse is the
        point of the prefix store); pass ``release_operator`` to also
        free that operator's prefix pages once their requests are served
        (``OperatorSession.close`` does this for you)."""
        self._sweep_deadlines()
        if self._scheduler is not None:
            for res in self._scheduler.drain():
                self._resolve_scheduled(res)
        for qlen, dec in list(self._inflight.items()):
            with self._transfer_guard():
                dec.drain()
            # retire the idle decoder: fold its counters into the engine
            # and drop it so per-qlen decoders don't accumulate forever
            steps, slots = self._retired_inflight
            self._retired_inflight = (steps + dec.n_steps,
                                      slots + dec.n_slot_steps)
            cancels, faults = self._retired_faults
            self._retired_faults = (cancels + dec.n_cancelled,
                                    faults + dec.n_stage_faults)
            self._retired_spec.merge(dec.spec_stats)
            del self._inflight[qlen]
        out, remaining = [], []
        for rid in self._order:
            fut = self._futures[rid]
            if fut.done():
                out.append(fut._response)
                del self._futures[rid]
            else:
                remaining.append(rid)
        self._order = remaining
        if release_operator is not None:
            self.release_prefixes(release_operator)
        if self.debug_invariants:
            self._audit_pool()
        self.check_sanitizers()
        return out

    # ---- runtime sanitizers (repro_torch.analysis.sanitizers) ----

    def _transfer_guard(self):
        """The transfer guard around the decode pump when
        ``debug_transfers`` is on (on a CUDA executor); a no-op context
        otherwise."""
        return transfer_guard_ctx(self.debug_transfers,
                                  executor_device(self.executor))

    def arm_sanitizers(self) -> Optional[int]:
        """Snapshot the census after warmup. From here on every pump/drain
        asserts a zero budget (requires ``debug_recompiles=True``; returns
        the census count at arm, or None when the sanitizer is off)."""
        if self._recompile_sanitizer is None:
            return None
        return self._recompile_sanitizer.arm()

    def check_sanitizers(self, budget: int = 0) -> None:
        """Raise ``RecompileBudgetError`` if steady state built or
        allocated more than ``budget`` new items since
        ``arm_sanitizers()``. No-op until armed. A trip dumps the flight
        ring first so the failing run leaves a diagnosable artifact."""
        san = self._recompile_sanitizer
        if san is not None and san.armed_at is not None:
            try:
                san.check(budget)
            except Exception:
                self.flight.dump("recompile_budget")
                raise

    def _audit_pool(self) -> None:
        """``PagePool.check_invariants`` with a flight dump on failure:
        a tripped page-pool invariant in a chaos run becomes a JSON
        artifact instead of a bare assert."""
        try:
            self.kv_pool.check_invariants()
        except Exception:
            self.flight.dump("pool_invariant")
            raise

    # ---- observability exports ----

    def dump_trace(self, path: str) -> str:
        """Write every recorded request trace as Chrome/Perfetto
        ``trace_event`` JSON (open at https://ui.perfetto.dev). Tracks:
        one per operator (pid 1), one per decode slot (pid 2), and, with
        profiling on, one per device stage (pid 3)."""
        if self.profiler is None:
            return self.tracer.dump(path)
        import json
        import os
        doc = self.tracer.to_chrome()
        doc["traceEvents"] = (doc["traceEvents"]
                              + self.profiler.chrome_events())
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def dump_flight(self, path: str, reason: str = "manual"
                    ) -> Optional[str]:
        """Write the flight-recorder ring (last N engine events plus a
        ``stats()`` snapshot) as JSON to ``path``."""
        return self.flight.dump(reason, path=path, stats=self.stats)

    def release_prefixes(self, operator_id: str) -> int:
        """Free one operator's cached prefix pages (their store pin —
        pages shared with still-active requests free when those
        finish) and their cached draft prefill rows. Returns the number
        of prefix entries released."""
        for skey in [k for k in self._draft_prefix_rows
                     if k[0][0] == operator_id]:
            del self._draft_prefix_rows[skey]
        return self.kv_pool.release_operator(operator_id)

    # ---- profiled mission path (analytic edge + LUT/oracle fidelity) ----

    def submit_frame(self, session: OperatorSession, t: float,
                     intent: Intent = Intent.INSIGHT) -> Response:
        rid, self._seq = self._seq, self._seq + 1
        self._bump("submitted")
        self._advance(t)
        if self.tracer.enabled:
            self.tracer.begin(rid, session.operator_id,
                              intent=intent.name, t=t)
        reason = self.scheduler_proto.admission_check(session.operator_id,
                                                      t)
        if reason is not None:       # rate-limited: shed pre-edge-compute
            self._bump("rejected")
            self.flight.record("rejected", t, request_id=rid)
            if self.tracer.enabled:
                self.tracer.point(rid, "rejected", t, reason=reason)
            return Response(request_id=rid,
                            operator_id=session.operator_id,
                            intent=intent, feasible=False,
                            failure="rejected", t_submit=t, t_delivered=t,
                            t_finished=t)
        deadline = self._deadline_for(session, intent, t)
        transport, decision, bw = self._decide(session, intent, t)
        if decision.stream == "context":
            return self._context_frame(session, transport, rid, t)
        attempts, t_try, prev_tier = 0, t, None
        compute_total = energy_total = 0.0
        while True:
            attempts += 1
            if decision.tier is None:
                self._bump("infeasible")
                self.flight.record("infeasible", t_try, request_id=rid)
                if self.tracer.enabled:
                    self.tracer.point(rid, "infeasible", t_try)
                return Response(request_id=rid,
                                operator_id=session.operator_id,
                                intent=intent, feasible=False,
                                failure="infeasible", attempts=attempts,
                                t_submit=t, t_delivered=t_try,
                                edge_compute_s=compute_total,
                                edge_energy_j=energy_total)
            tier = decision.tier
            flops = edge_insight_flops(self.deploy, tier.ratio)
            compute_s = self.edge_device.latency_s(flops)
            compute_total += compute_s
            energy_total += (self.edge_device.compute_energy_j(flops)
                             + self.edge_device.tx_energy_j(
                                 tier.payload_mb * 1e6))
            packet = pk.Packet(kind="insight", tier_name=tier.name,
                               seq_id=rid, created_at=t_try,
                               payload_bytes=int(tier.payload_mb * 1e6))
            rec = transport.send(packet, t_try + compute_s)
            self._advance(rec.end_s)
            if not rec.delivered:
                self.flight.record("blackout", rec.end_s, request_id=rid)
            if self.tracer.enabled:
                self.tracer.span(rid, "edge_encode", t_try,
                                 t_try + compute_s, tier=tier.name)
                if rec.delivered:
                    self.tracer.span(rid, "transmit", rec.start_s,
                                     rec.end_s, tier=tier.name)
                else:
                    self.tracer.point(rid, "blackout", rec.end_s)
            if rec.delivered:
                break
            # blackout: retry with backoff + downshift while the budget
            # (attempt cap, deadline) holds — same loop as the real path
            t_next = (rec.end_s + self.retry.backoff_s(attempts)
                      if self.retry is not None else rec.end_s)
            if (self.retry is None or attempts >= self.retry.max_attempts
                    or (deadline is not None and t_next >= deadline)):
                self._bump("blackouts")
                return Response(request_id=rid,
                                operator_id=session.operator_id,
                                intent=intent, tier_name=tier.name,
                                feasible=False, failure="blackout",
                                attempts=attempts, t_submit=t,
                                t_delivered=rec.end_s,
                                edge_compute_s=compute_total,
                                edge_energy_j=energy_total)
            self._bump("retries")
            self.flight.record("retry", t_next, request_id=rid)
            if self.tracer.enabled:
                self.tracer.point(rid, "retry", t_next)
            prev_tier, t_try = tier, t_next
            self._advance(t_try)
            transport, decision, bw = self._decide(session, intent, t_try)
            decision = self.retry.downshifted(decision, prev_tier, self.lut,
                                              bw)
            if (decision.tier is not None
                    and decision.tier.payload_mb < prev_tier.payload_mb):
                self._bump("downshifts")
        if deadline is not None and rec.end_s >= deadline:
            self._bump("deadline_cancelled")
            self.flight.record("cancelled", rec.end_s, request_id=rid)
            if self.tracer.enabled:
                self.tracer.point(rid, "cancelled", rec.end_s,
                                  reason="deadline")
            self.flight.dump("deadline_cancel", stats=self.stats)
            return Response(request_id=rid, operator_id=session.operator_id,
                            intent=intent, tier_name=tier.name,
                            feasible=False, failure="deadline",
                            attempts=attempts, t_submit=t,
                            t_delivered=rec.end_s,
                            edge_compute_s=compute_total,
                            edge_energy_j=energy_total)
        iou = (session.oracle.measure(tier)
               if session.oracle is not None else None)
        self.flight.record("served", rec.end_s, request_id=rid)
        if self.tracer.enabled:
            self.tracer.point(rid, "served", rec.end_s)
        self._bump("completed")
        self._note_served(session.operator_id)
        if not decision.feasible:
            self._bump("starved")        # served best-effort, F_I unmet
        return Response(request_id=rid, operator_id=session.operator_id,
                        intent=intent, tier_name=tier.name,
                        feasible=decision.feasible, attempts=attempts,
                        iou=iou, t_submit=t, t_delivered=rec.end_s,
                        edge_compute_s=compute_total,
                        edge_energy_j=energy_total)

    def _context_frame(self, session: OperatorSession, transport: Transport,
                       rid: int, t: float) -> Response:
        """Profiled Context-stream frame: the CLIP-only edge pathway and
        the fixed lightweight payload (always feasible, no tier)."""
        deploy = self.deploy
        flops = (patch_embed_flops(deploy.clip.d_model,
                                   deploy.context_patch_size,
                                   deploy.clip_tokens)
                 + encoder_flops(deploy.clip, deploy.clip_tokens))
        compute_s = self.edge_device.latency_s(flops)
        payload_mb = self.lut.context.payload_mb
        energy = (self.edge_device.compute_energy_j(flops)
                  + self.edge_device.tx_energy_j(payload_mb * 1e6))
        packet = pk.Packet(kind="context", tier_name=None, seq_id=rid,
                           created_at=t,
                           payload_bytes=int(payload_mb * 1e6))
        rec = transport.send(packet, t + compute_s)
        self._advance(rec.end_s)
        self.flight.record("served" if rec.delivered else "blackout",
                           rec.end_s, request_id=rid)
        if self.tracer.enabled:
            self.tracer.span(rid, "edge_encode", t, t + compute_s)
            if rec.delivered:
                self.tracer.span(rid, "transmit", rec.start_s, rec.end_s)
                self.tracer.point(rid, "served", rec.end_s)
            else:
                self.tracer.point(rid, "blackout", rec.end_s)
        if not rec.delivered:
            self._bump("blackouts")
        else:
            self._bump("completed")
            self._note_served(session.operator_id)
        return Response(request_id=rid, operator_id=session.operator_id,
                        intent=Intent.CONTEXT, tier_name=None,
                        feasible=rec.delivered,
                        failure=None if rec.delivered else "blackout",
                        t_submit=t, t_delivered=rec.end_s,
                        edge_compute_s=compute_s, edge_energy_j=energy)

    # ---- telemetry ----

    @property
    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "submitted": self.n_submitted,
            "completed": self.n_completed,
            "infeasible": self.n_infeasible,
            "blackouts": self.n_blackouts,
            "deadline_cancelled": self.n_deadline,
            "cloud_errors": self.n_cloud_errors,
            "rejected": self.n_rejected,
            "starved": self.n_starved,
            "retries": self.n_retries,
            "downshifts": self.n_downshifts,
            "load_downshifts": self.n_load_downshifts,
        }
        # scheduler telemetry (queue depth/waits per class, preemptions,
        # rejection reasons) and per-operator served counts — the
        # fairness surface for fleet-scale multi-tenant serving
        out.update(self.scheduler_proto.stats())
        for op, n in self.served_by_operator.items():
            out[f"served_op:{op}"] = n
        if self._scheduler is not None:
            out["n_microbatches"] = self._scheduler.n_microbatches
            out["mean_batch_size"] = self._scheduler.mean_batch_size
        if self.batching == "inflight":
            steps, slots = self._retired_inflight
            steps += sum(d.n_steps for d in self._inflight.values())
            slots += sum(d.n_slot_steps for d in self._inflight.values())
            out["inflight_steps"] = steps
            out["mean_live_slots"] = slots / steps if steps else 0.0
            cancels, faults = self._retired_faults
            out["inflight_cancelled"] = cancels + sum(
                d.n_cancelled for d in self._inflight.values())
            out["stage_faults"] = faults + sum(
                d.n_stage_faults for d in self._inflight.values())
            out.update(self.kv_pool.stats())
            if self.spec_config is not None:
                out.update(self._merged_spec_stats().as_dict())
        if self.executor is not None:
            out["compiled_stages"] = self.executor.num_compiled_stages
        if self._recompile_sanitizer is not None:
            out["compiled_traces"] = \
                self._recompile_sanitizer.compile_count()
            if self._recompile_sanitizer.armed_at is not None:
                out["new_compiles_since_arm"] = \
                    self._recompile_sanitizer.new_compiles()
        if self.mesh is not None:
            out["mesh_devices"] = self.mesh.size
            out["model_shards"] = getattr(self.executor, "model_shards", 1)
        # observability summary: fixed keys read off the registry's
        # latency histograms — present whether or not the tracer is on, so
        # traced and untraced runs report the same surface. The full
        # labelled registry is engine.metrics.as_dict().
        for cls in QOS_CLASSES:
            ttft = self.metrics.histogram(f"ttft_s:{cls}")
            out[f"ttft_{cls}_p50_s"] = ttft.p50
            out[f"ttft_{cls}_p99_s"] = ttft.p99
            out[f"ttft_{cls}_n"] = ttft.count
            out[f"queue_wait_{cls}_p95_s"] = self.metrics.histogram(
                f"queue_wait_s:{cls}").p95
            out[f"tokens_per_s_{cls}_p50"] = self.metrics.histogram(
                f"tokens_per_s:{cls}", hi=1e6).p50
        transmit = self.metrics.histogram("transmit_s")
        out["transmit_p50_s"] = transmit.p50
        out["transmit_p99_s"] = transmit.p99
        decode = self.metrics.histogram("decode_step_s")
        out["decode_step_p50_s"] = decode.p50
        out["decode_step_p99_s"] = decode.p99
        out["flight_events"] = len(self.flight)
        out["flight_dumps"] = self.flight.n_dumps
        # device-level profiler summary: only present when profiling was
        # requested, so the default stats surface is unchanged without it
        if self.profiler is not None:
            out.update(self.profiler.stats_block())
        return out
