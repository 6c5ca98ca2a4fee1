"""Packetisation of transmitted representations (host copy of
``repro/core/packets.py``). Payload accounting is exact: int8 codes +
fp16 per-token scales for bottlenecked Insight activations, fp16 for
Context features, plus a fixed header."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

HEADER_BYTES = 64
FP16_BYTES = 2
INT8_BYTES = 1


@dataclass
class Packet:
    kind: str                      # "context" | "insight"
    tier_name: Optional[str]       # Insight tier, None for context
    seq_id: int
    created_at: float              # simulation time (s)
    payload_bytes: int
    content: Dict[str, Any] = field(default_factory=dict, repr=False)

    @property
    def payload_mb(self) -> float:
        return self.payload_bytes / 1e6


def insight_payload_bytes(num_tokens: int, rank: int,
                          clip_tokens: int = 0, clip_dim: int = 0) -> int:
    codes = num_tokens * rank * INT8_BYTES
    scales = num_tokens * FP16_BYTES
    clip = clip_tokens * clip_dim * FP16_BYTES
    return HEADER_BYTES + codes + scales + clip


def context_payload_bytes(ctx_tokens: int, dim: int) -> int:
    return HEADER_BYTES + ctx_tokens * dim * FP16_BYTES


def make_insight_packet(seq_id: int, now: float, tier_name: str,
                        codes: np.ndarray, scales: np.ndarray,
                        clip_feats: Optional[np.ndarray] = None) -> Packet:
    nbytes = HEADER_BYTES + codes.size * INT8_BYTES + scales.size * FP16_BYTES
    content = {"codes": codes, "scales": scales}
    if clip_feats is not None:
        nbytes += clip_feats.size * FP16_BYTES
        content["clip"] = clip_feats
    return Packet(kind="insight", tier_name=tier_name, seq_id=seq_id,
                  created_at=now, payload_bytes=nbytes, content=content)


def make_context_packet(seq_id: int, now: float,
                        ctx_feats: np.ndarray) -> Packet:
    return Packet(kind="context", tier_name=None, seq_id=seq_id,
                  created_at=now,
                  payload_bytes=HEADER_BYTES + ctx_feats.size * FP16_BYTES,
                  content={"ctx": ctx_feats})
