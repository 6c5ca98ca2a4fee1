"""AVERY engine (port of ``repro/engine``): the intent-driven
request/response front door.

  api         — Request / Response / StreamEvent / RequestFuture
  transport   — Transport protocol; ChannelTransport, LoopbackTransport
  policy      — ControlPolicy protocol; Adaptive / StaticTier / BestEffort;
                RetryPolicy (backoff + tier downshift on failure)
  scheduler   — admission policy: FifoScheduler (default), QoSScheduler
                (intent QoS classes, weighted-fair + strict-priority,
                rate limits, page-rollback preemption)
  faults      — chaos injection: FaultInjector (transport), FaultyExecutor
  inflight    — token-level continuous batching (join a running decode)
  speculative — Context-stream DraftModel + paged multi-token verify
  observability — Tracer (per-request spans -> Perfetto JSON),
                MetricsRegistry (counters/gauges/log-bucket histograms),
                FlightRecorder (bounded ring, crash dumps)
  engine      — AveryEngine + OperatorSession

The stage profiler (``StageProfiler``, ``CompileObservatory``,
``CloudCostModel``) is not ported yet (ROADMAP.md, Queue 1 item 4b).
"""
from repro_torch.engine.api import (Request, RequestFuture, Response,
                                    StreamEvent)
from repro_torch.engine.engine import AveryEngine, OperatorSession
from repro_torch.engine.faults import (CloudStageError, FaultInjector,
                                       FaultyExecutor)
from repro_torch.engine.inflight import InflightDecoder
from repro_torch.engine.observability import (Counter, FlightRecorder,
                                              Gauge, Histogram,
                                              MetricsRegistry, RequestTrace,
                                              Span, Tracer,
                                              validate_chrome_trace,
                                              validate_trace,
                                              validate_traces)
from repro_torch.engine.policy import (AdaptivePolicy, BestEffortPolicy,
                                       ControlPolicy, RetryPolicy,
                                       StaticTierPolicy, TierDecision,
                                       policy_from_mode)
from repro_torch.engine.scheduler import (QOS_LATENCY, QOS_THROUGHPUT,
                                          FifoScheduler, QoSScheduler,
                                          jain_index, qos_class)
from repro_torch.engine.speculative import (DraftModel, SpecStats,
                                            SpeculativeConfig)
from repro_torch.engine.transport import (ChannelTransport,
                                          LoopbackTransport, Transport)

__all__ = [
    "Request", "Response", "StreamEvent", "RequestFuture",
    "AveryEngine", "OperatorSession", "InflightDecoder",
    "ControlPolicy", "TierDecision", "AdaptivePolicy", "StaticTierPolicy",
    "BestEffortPolicy", "RetryPolicy", "policy_from_mode",
    "FifoScheduler", "QoSScheduler", "jain_index", "qos_class",
    "QOS_LATENCY", "QOS_THROUGHPUT",
    "CloudStageError", "FaultInjector", "FaultyExecutor",
    "DraftModel", "SpecStats", "SpeculativeConfig",
    "Transport", "ChannelTransport", "LoopbackTransport",
    "Tracer", "Span", "RequestTrace", "MetricsRegistry",
    "Counter", "Gauge", "Histogram", "FlightRecorder",
    "validate_trace", "validate_traces", "validate_chrome_trace",
]
