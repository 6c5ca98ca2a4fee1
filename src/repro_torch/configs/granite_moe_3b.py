"""granite-moe-3b-a800m — fine-grained MoE, top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

32L, d_model=1536, 24 heads (GQA kv=8), vocab=49155, 40 experts with
d_ff_expert=512, top-8 routing.
"""
from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (family card)",
)
