"""Analytic compute/energy device models (host copy of
``repro/network/energy.py``).

Latency and energy here are *derived*, not timed: FLOPs come from
analytic per-block formulas, and the device constants below convert them
to seconds and joules. The engine's profiled mission path
(``AveryEngine.submit_frame``) charges each frame's edge compute with them.

Constants:
  * Edge (paper's UAV computer): NVIDIA Jetson AGX Xavier, MODE_30W_ALL,
    at the effective throughput implied by the paper's Fig. 8 and 15 W
    (the reference's, unchanged).
  * Cloud: the card the port serves on, an NVIDIA H100 SXM (datasheet:
    989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, 700 W
    board power). ``CloudDevice()`` and the ``H100_SXM`` preset carry
    them; a card run below 700 W passes its own power limit
    (``dataclasses.replace(H100_SXM, power_watts=...)``).
  * The reference's TPU v5e constants stay under their own names
    (``TPU_V5E_*``, the ``TPU_V5E`` preset). They describe the reference's
    target, not the card; only the parity tests pass them, to both
    packages alike, so that FLOPs, bytes and joules compare exactly.
  * Radio: long-range uplink ~ 120 nJ/bit transmit energy.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

# --- hardware constants ---
JETSON_FLOPS = 1.28e12          # effective fp16 FLOP/s (Fig. 8 calibrated:
                                # split@1 edge latency == 0.2318 s)
JETSON_POWER_W = 15.0           # average active power in MODE_30W_ALL
H100_FLOPS = 989e12             # dense bf16 FLOP/s (H100 SXM datasheet)
H100_HBM_BPS = 3.35e12          # HBM3 bytes/s
H100_POWER_W = 700.0            # board power (the maximum power limit)
TPU_V5E_FLOPS = 197e12          # bf16 FLOP/s per chip
TPU_V5E_HBM_BPS = 819e9         # bytes/s
TPU_V5E_ICI_BPS = 50e9          # bytes/s per link
TPU_V5E_POWER_W = 170.0         # nameplate per-chip power envelope
RADIO_J_PER_BIT = 120e-9


@dataclass(frozen=True)
class EdgeDevice:
    flops_per_sec: float = JETSON_FLOPS
    power_watts: float = JETSON_POWER_W

    def latency_s(self, flops: float) -> float:
        return flops / self.flops_per_sec

    def compute_energy_j(self, flops: float) -> float:
        return self.latency_s(flops) * self.power_watts

    def tx_energy_j(self, payload_bytes: float) -> float:
        return payload_bytes * 8 * RADIO_J_PER_BIT


@dataclass(frozen=True)
class CloudDevice:
    """The cloud serving card's roofline constants (H100 SXM defaults).
    ``roofline_s`` is the lower bound a stage's measured wall time is
    compared against: max of compute-bound and bandwidth-bound time."""
    flops_per_sec: float = H100_FLOPS
    hbm_bytes_per_sec: float = H100_HBM_BPS
    power_watts: float = H100_POWER_W

    def latency_s(self, flops: float) -> float:
        return flops / self.flops_per_sec

    def roofline_s(self, flops: float, hbm_bytes: float) -> float:
        return max(flops / self.flops_per_sec,
                   hbm_bytes / self.hbm_bytes_per_sec)

    def compute_energy_j(self, flops: float) -> float:
        return self.latency_s(flops) * self.power_watts


H100_SXM = CloudDevice(H100_FLOPS, H100_HBM_BPS, H100_POWER_W)
# the reference's default cloud device, for parity tests only
TPU_V5E = CloudDevice(TPU_V5E_FLOPS, TPU_V5E_HBM_BPS, TPU_V5E_POWER_W)


# ---------------------------------------------------------------------------
# analytic FLOPs (2 * MACs convention)
# ---------------------------------------------------------------------------


def attn_block_flops(d: int, d_ff: int, seq: int, heads: int,
                     kv_heads: int, head_dim: int, gated: bool) -> float:
    """One transformer block, full-sequence, per batch element."""
    qkvo = 2 * seq * d * (heads * head_dim + 2 * kv_heads * head_dim
                          + heads * head_dim)
    scores = 2 * seq * seq * heads * head_dim * 2   # QK^T and PV
    mlp = 2 * seq * d * d_ff * (3 if gated else 2)
    return float(qkvo + scores + mlp)


def encoder_flops(cfg: ModelConfig, seq: int, num_blocks: int = -1) -> float:
    """Encoder prefix of ``num_blocks`` blocks (-1 = all), per image."""
    n = cfg.num_layers if num_blocks < 0 else num_blocks
    return n * attn_block_flops(cfg.d_model, cfg.d_ff, seq, cfg.num_heads,
                                cfg.num_kv_heads, cfg.resolved_head_dim,
                                cfg.gated_mlp)


def bottleneck_flops(d: int, rank: int, seq: int) -> float:
    return float(2 * seq * d * rank)


def decode_token_flops(cfg: ModelConfig, ctx_len: int) -> float:
    """One autoregressive decode step (single token, KV cache of
    ``ctx_len`` attended positions), per batch row: qkvo + mlp are the
    seq=1 slice of :func:`attn_block_flops`; scores attend the full
    cached context."""
    d, heads, head_dim = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    qkvo = 2 * d * (heads * head_dim + 2 * cfg.num_kv_heads * head_dim
                    + heads * head_dim)
    scores = 2 * ctx_len * heads * head_dim * 2     # QK^T and PV
    mlp = 2 * d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    return float(cfg.num_layers * (qkvo + scores + mlp))


def decode_token_hbm_bytes(cfg: ModelConfig, ctx_len: int,
                           dtype_bytes: int = 2) -> float:
    """Dominant HBM traffic of one decode step, per batch row: the K and
    V cache reads over ``ctx_len`` positions in every layer (weight
    reads amortise over the batch; activations are tiny at seq=1)."""
    return float(2 * cfg.num_layers * ctx_len * cfg.num_kv_heads
                 * cfg.resolved_head_dim * dtype_bytes)


def patch_embed_flops(d: int, patch: int, seq: int, in_ch: int = 3) -> float:
    return float(2 * seq * patch * patch * in_ch * d)


# ---------------------------------------------------------------------------
# per-frame edge cost at a deployment geometry (used by the engine's
# profiled mission path)
# ---------------------------------------------------------------------------


def edge_insight_flops(deploy, ratio: float) -> float:
    """Edge-side FLOPs per Insight frame at the deployment geometry:
    patch embed + SAM blocks [0, k) + bottleneck encode + CLIP encoder.
    ``deploy`` is a ``LISAPipelineConfig``."""
    from repro_torch.core import bottleneck as bn
    d = deploy.sam.d_model
    orig_bytes = 2 if deploy.sam.param_dtype == "bfloat16" else 4
    rank = bn.rank_for_ratio(d, ratio, orig_bytes)
    return (patch_embed_flops(d, deploy.patch_size, deploy.sam_tokens)
            + encoder_flops(deploy.sam, deploy.sam_tokens,
                            deploy.split_layer)
            + bottleneck_flops(d, rank, deploy.sam_tokens)
            + patch_embed_flops(deploy.clip.d_model,
                                deploy.context_patch_size, deploy.clip_tokens)
            + encoder_flops(deploy.clip, deploy.clip_tokens))


def full_edge_flops(deploy) -> float:
    """Full onboard execution of the Insight segmentation backbone."""
    d = deploy.sam.d_model
    return (patch_embed_flops(d, deploy.patch_size, deploy.sam_tokens)
            + encoder_flops(deploy.sam, deploy.sam_tokens))
