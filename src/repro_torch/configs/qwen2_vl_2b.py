"""qwen2-vl-2b — VLM decoder with M-RoPE. [arXiv:2409.12191]

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
M-RoPE sections (16, 24, 24) over half-dim 64 for (temporal, h, w)
position streams. The ViT vision encoder is a stub: inputs arrive as 256
precomputed patch embeddings (dim 1280) per image, projected into the
decoder. The arch closest to LISA's topology (vision features consumed by
a language decoder).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_style="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    modality="vlm",
    frontend_dim=1280,
    num_vision_tokens=256,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2409.12191 (Qwen2-VL: M-RoPE, dynamic resolution ViT)",
)
