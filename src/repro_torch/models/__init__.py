from repro_torch.models.config import (HybridConfig, MLAConfig, MoEConfig,
                                       ModelConfig, SSMConfig)

__all__ = ["ModelConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "HybridConfig"]
