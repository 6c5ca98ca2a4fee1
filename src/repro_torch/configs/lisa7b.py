"""LISA-7B — the paper's own model: SAM ViT-H vision backbone + CLIP
context encoder + LLaMA-7B multi-modal LLM + mask decoder (host copy of
``repro/configs/lisa7b.py``)."""
from dataclasses import dataclass
from typing import Tuple

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class LISAPipelineConfig:
    name: str
    sam: ModelConfig            # Insight vision backbone (encoder)
    clip: ModelConfig           # Context encoder
    llm: ModelConfig            # multi-modal reasoning core
    image_size: int             # Insight-stream input resolution
    patch_size: int
    context_image_size: int     # Context-stream (low-res) input
    context_patch_size: int
    split_layer: int = 1        # split@1 (paper §5.2.1)
    bottleneck_ratios: Tuple[float, ...] = (0.25, 0.10, 0.05)
    mask_pixels_per_patch: int = 0  # 0 -> mask at patch resolution

    @property
    def sam_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def clip_tokens(self) -> int:
        return (self.context_image_size // self.context_patch_size) ** 2


def _encoder(name, layers, d, heads, d_ff, dtype="bfloat16") -> ModelConfig:
    return ModelConfig(
        name=name, arch_type="dense", num_layers=layers, d_model=d,
        num_heads=heads, num_kv_heads=heads, d_ff=d_ff, vocab_size=1,
        causal=False, rope_style="none", norm="layernorm", mlp_act="gelu",
        gated_mlp=False, param_dtype=dtype, act_dtype=dtype)


CONFIG = LISAPipelineConfig(
    name="lisa-7b",
    # SAM ViT-H: 32 blocks, d=1280, 16 heads, 1024px / patch 16 -> 4096 tokens
    sam=_encoder("sam-vit-h", 32, 1280, 16, 5120),
    # CLIP ViT-B/16: 12 blocks, d=768, 12 heads, 224px / patch 16 -> 196
    clip=_encoder("clip-vit-b16", 12, 768, 12, 3072),
    # LLaMA-7B: 32L d=4096 MHA 32H d_ff=11008
    llm=ModelConfig(
        name="llama-7b", arch_type="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=32000,
        param_dtype="bfloat16", act_dtype="bfloat16"),
    image_size=1024, patch_size=16,
    context_image_size=224, context_patch_size=16,
    split_layer=1,
)
