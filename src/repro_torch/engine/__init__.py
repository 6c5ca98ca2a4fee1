"""AVERY serving engine (port of ``repro/engine``), as far as the paged
in-flight decoder needs it:

  scheduler     — FifoScheduler (default), QoSScheduler (intent QoS
                  classes, weighted-fair + strict-priority, rate limits,
                  page-rollback preemption)
  faults        — CloudStageError
  inflight      — InflightDecoder: token-level continuous batching over a
                  paged, shared-prefix KV pool
  observability — Tracer (per-request spans -> Perfetto JSON)

``AveryEngine``, the API types, policies, transport, speculation and the
profiler are not ported yet (ROADMAP.md, Queue 1).
"""
from repro_torch.engine.faults import CloudStageError
from repro_torch.engine.inflight import InflightDecoder
from repro_torch.engine.observability import RequestTrace, Span, Tracer
from repro_torch.engine.scheduler import (QOS_LATENCY, QOS_THROUGHPUT,
                                          FifoScheduler, QoSScheduler,
                                          jain_index, qos_class)

__all__ = [
    "InflightDecoder", "CloudStageError",
    "FifoScheduler", "QoSScheduler", "jain_index", "qos_class",
    "QOS_LATENCY", "QOS_THROUGHPUT",
    "Tracer", "Span", "RequestTrace",
]
