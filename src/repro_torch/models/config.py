"""Model configuration dataclasses (host copy of ``repro/models/config.py``).

Plain data: the same fields and defaults as the reference. ``pdtype`` and
``adtype`` map the dtype names to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype name {name!r}; have "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3, MiniCPM3)."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dispatch: str = "einsum"
    first_k_dense: int = 0
    d_ff_dense: int = 0


@dataclass(frozen=True)
class SSMConfig:
    version: int              # 1 = Mamba-1 selective scan, 2 = Mamba-2 SSD
    state_size: int           # N
    expand: int = 2
    conv_kernel: int = 4
    head_dim: int = 64
    dt_rank: int = 0


@dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 9


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    mlp_act: str = "silu"     # silu (=SwiGLU), relu2, gelu
    gated_mlp: bool = True
    attn_type: str = "gqa"    # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_style: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: Optional[int] = None
    causal: bool = True
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-6
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    mtp: bool = False
    mtp_weight: float = 0.3
    modality: str = "text"
    frontend_dim: int = 0
    num_vision_tokens: int = 0
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    remat: bool = False
    use_flash: bool = False
    # route single-token GQA decode attention through the hand-written
    # flash-decode CUDA kernel (kernels/decode_attention)
    use_flash_decode: bool = False
    attn_chunk: Optional[int] = None
    attn_scores_stub: bool = False
    use_ssm_kernel: bool = False
    scan_unroll: bool = False
    seq_shard: bool = False
    shard_cache_hd: bool = False
    tie_embeddings: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.act_dtype)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """True if a 500k-token decode context is feasible: SSM/hybrid state
        is O(1); windowed attention caches only ``sliding_window`` slots."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_sliding_window(self, window: int = 8192) -> "ModelConfig":
        """The beyond-paper variant the dry-run's long_500k uses for
        dense archs."""
        return self.replace(sliding_window=window)

    def param_count(self) -> int:
        """Analytic parameter count (exact for our layouts)."""
        from repro_torch.models import stack
        return stack.count_params(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        from repro_torch.models import stack
        return stack.count_params(self, active_only=True)
