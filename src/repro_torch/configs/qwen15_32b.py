"""qwen1.5-32b — dense MHA (kv=40) with QKV bias. [hf:Qwen/Qwen1.5-0.5B]

64L, d_model=5120, 40 heads (kv=40), d_ff=27392, vocab=152064.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="hf:Qwen/Qwen1.5-0.5B (family card; QKV bias, SwiGLU, RMSNorm)",
)
