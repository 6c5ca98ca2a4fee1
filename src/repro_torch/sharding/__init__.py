from repro_torch.sharding.specs import (batch_specs, cache_specs, param_specs,
                                        serving_specs, shard_tree)

__all__ = ["param_specs", "batch_specs", "cache_specs", "serving_specs",
           "shard_tree"]
