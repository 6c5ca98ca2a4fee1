"""deepseek-v3-671b — MLA + fine-grained MoE (1 shared + 256 routed,
top-8) + multi-token prediction. [arXiv:2412.19437]

61L, d_model=7168, 128 heads MLA (q_lora=1536, kv_lora=512, nope=128,
rope=64, v=128), routed expert d_ff=2048, first 3 layers dense
(d_ff=18432), vocab=129280. The MLA latent KV cache (512+64 per token) is
itself a learned boundary compression, akin to AVERY's bottleneck.
"""
from repro_torch.models import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, d_ff_shared=2048,
                  first_k_dense=3, d_ff_dense=18432),
    mtp=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2412.19437 (DeepSeek-V3: MLA, 1 shared + 256 routed, MTP)",
)
