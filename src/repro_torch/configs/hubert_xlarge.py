"""hubert-xlarge — encoder-only audio transformer. [arXiv:2106.07447]

48L, d_model=1280, 16 heads (kv=16), d_ff=5120, vocab=504 (cluster
codebook). Bidirectional (non-causal); trained with masked-unit
prediction. The conv waveform feature extractor is a stub: inputs
arrive as (B, T, 512) frame features.

Encoder-only: there is no decode step.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    rope_style="none",
    norm="layernorm",
    mlp_act="gelu",
    gated_mlp=False,
    modality="audio",
    frontend_dim=512,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2106.07447 (HuBERT X-Large; w2v2-style encoder)",
)
