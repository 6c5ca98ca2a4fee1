"""nemotron-4-340b — dense GQA with squared-ReLU MLP. [arXiv:2402.16819]

96L, d_model=18432, 96 heads (GQA kv=8), d_ff=73728, vocab=256000.
Squared-ReLU is a single-projection (non-gated) MLP.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp_act="relu2",
    gated_mlp=False,
    norm="layernorm",
    rope_theta=10000.0,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2402.16819 (Nemotron-4 340B: GQA kv=8, squared-ReLU)",
)
