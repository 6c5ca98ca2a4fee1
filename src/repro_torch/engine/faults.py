"""Cloud-stage failures of the serving path (port of part of
``repro/engine/faults.py``).

Only ``CloudStageError`` is ported: the in-flight decoder turns it into
per-request ``cloud_error`` failures. The fault injectors
(``FaultInjector``, ``FaultyExecutor``) need the transport and the network
channel, and come with the engine front door (ROADMAP.md, Queue 1).
"""
from __future__ import annotations


class CloudStageError(RuntimeError):
    """A cloud serving stage failed mid-request. The in-flight decoder
    converts it into per-request ``cloud_error`` failures with pages
    released refcount-safely."""
