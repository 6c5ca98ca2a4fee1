"""LISA-mini — the small proxy of the LISA topology (host copy of
``repro/configs/lisa_mini.py``): 32x32 images, SAM-mini on 4px patches
(64 tokens), CLIP-mini on 8px patches (16 tokens), 4x4 mask pixels per
patch."""
from repro_torch.configs.lisa7b import LISAPipelineConfig, _encoder
from repro_torch.models.config import ModelConfig

CONFIG = LISAPipelineConfig(
    name="lisa-mini",
    sam=_encoder("sam-mini", 4, 128, 4, 256, dtype="float32"),
    clip=_encoder("clip-mini", 2, 64, 4, 128, dtype="float32"),
    llm=ModelConfig(
        name="llm-mini", arch_type="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=64,
        param_dtype="float32", act_dtype="float32"),
    image_size=32, patch_size=4,
    context_image_size=32, context_patch_size=8,
    split_layer=1,
    mask_pixels_per_patch=16,
)
