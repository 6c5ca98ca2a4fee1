"""falcon-mamba-7b — pure Mamba-1 SSM, attention-free. [arXiv:2410.05355]

64L, d_model=4096, d_inner=8192 (expand 2), ssm_state=16, vocab=65024.
No KV cache: decode state is O(1) in context length.
"""
from repro_torch.models import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    attn_type="none",
    rope_style="none",
    ssm=SSMConfig(version=1, state_size=16, expand=2, conv_kernel=4),
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2410.05355 (Falcon Mamba: 7B attention-free Mamba-1)",
)
