from repro_torch.optim.adamw import Optimizer, adamw, sgd
from repro_torch.optim.schedules import (constant, cosine_with_warmup,
                                         linear_warmup)

__all__ = ["Optimizer", "adamw", "sgd",
           "cosine_with_warmup", "linear_warmup", "constant"]
