"""Operator intent taxonomy (host copy of ``repro/core/intent.py``).

CONTEXT — coarse semantic awareness; a text answer suffices.
INSIGHT — fine-grained spatial grounding; a segmentation mask is required.
``classify_intent`` is the keyword gate over the operator prompt.
"""
from __future__ import annotations

import enum
import re
from dataclasses import dataclass
from typing import Optional


class Intent(enum.Enum):
    CONTEXT = "context"
    INSIGHT = "insight"


@dataclass(frozen=True)
class IntentRequirements:
    """Service-level objectives induced by an intent."""
    min_update_pps: float         # F_I: minimum update throughput (packets/s)
    min_fidelity: float = 0.0     # Q_I: minimum Average IoU (Insight only)
    max_latency_s: Optional[float] = None   # per-request deadline, or none


DEFAULT_REQUIREMENTS = {
    Intent.CONTEXT: IntentRequirements(min_update_pps=2.0),
    Intent.INSIGHT: IntentRequirements(min_update_pps=0.5, min_fidelity=0.0),
}

_INSIGHT_PATTERNS = [
    r"\bhighlight\b", r"\bsegment\b", r"\bmark\b", r"\boutline\b",
    r"\bmask\b", r"\blocal[iz]e\b", r"\bpinpoint\b", r"\bshow exactly\b",
    r"\bwhere exactly\b", r"\bdraw\b", r"\btrace\b",
]
_CONTEXT_PATTERNS = [
    r"\bwhat is happening\b", r"\bany\b", r"\bis there\b", r"\bare there\b",
    r"\bhow many\b", r"\bdescribe\b", r"\bsummar", r"\bstatus\b",
    r"\bsurvey\b", r"\boverview\b",
]


def classify_intent(prompt: str) -> Intent:
    p = prompt.lower()
    insight = sum(bool(re.search(pat, p)) for pat in _INSIGHT_PATTERNS)
    context = sum(bool(re.search(pat, p)) for pat in _CONTEXT_PATTERNS)
    if insight > context:
        return Intent.INSIGHT
    if context > insight:
        return Intent.CONTEXT
    return Intent.INSIGHT if insight else Intent.CONTEXT


def admissible_streams(intent: Intent):
    """S(I_t): the stream set is a singleton per intent level."""
    from repro_torch.core.streams import Stream
    return (Stream.INSIGHT,) if intent is Intent.INSIGHT else (Stream.CONTEXT,)
