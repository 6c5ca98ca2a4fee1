from repro_torch.models.config import (HybridConfig, MLAConfig, MoEConfig,
                                       ModelConfig, SSMConfig)
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params, prefill_step)

__all__ = [
    "ModelConfig", "MLAConfig", "MoEConfig", "SSMConfig", "HybridConfig",
    "init_params", "forward", "init_cache", "prefill_step", "decode_step",
]
