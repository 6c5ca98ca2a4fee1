"""minicpm3-4b — dense model with MLA attention. [hf:openbmb/MiniCPM3-4B]

62L, d_model=2560, 40 heads (q_lora=768, kv_lora=256, nope=64, rope=32,
v=64), d_ff=6400, vocab=73448.
"""
from repro_torch.models import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="hf:openbmb/MiniCPM3-4B (MLA config from model card)",
)
