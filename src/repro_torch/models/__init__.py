from repro_torch.models.config import (HybridConfig, MLAConfig, MoEConfig,
                                       ModelConfig, SSMConfig)
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params, loss_and_grads, loss_fn,
                                      make_train_step, prefill_step)

__all__ = [
    "ModelConfig", "MLAConfig", "MoEConfig", "SSMConfig", "HybridConfig",
    "init_params", "forward", "loss_fn", "loss_and_grads",
    "make_train_step", "init_cache",
    "prefill_step", "decode_step",
]
