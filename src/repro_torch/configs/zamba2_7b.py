"""zamba2-7b — hybrid Mamba-2 backbone + shared attention block.
[arXiv:2411.15242]

81 Mamba-2 layers, d_model=3584, ssm_state=64; a single *parameter-shared*
attention+MLP block (32 heads MHA, d_ff=14336) is invoked every
``attn_every`` Mamba layers (Zamba2's shared-block design). 81 layers
factor as 9 super-groups x 9, the nearest divisor of the published
"every ~6 blocks" cadence.
"""
from repro_torch.models import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(version=2, state_size=64, expand=2, conv_kernel=4,
                  head_dim=64),
    hybrid=HybridConfig(attn_every=9),
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2411.15242 (Zamba2: Mamba-2 + shared attention blocks)",
)
