"""phi4-mini-3.8b — dense GQA, RoPE + SwiGLU. [arXiv:2412.08905]

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=200064.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    head_dim=128,
    tie_embeddings=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2412.08905 (Phi-4-mini: RoPE, SwiGLU, GQA kv=8)",
)
