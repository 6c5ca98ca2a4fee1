from repro_torch.kernels.bottleneck.ops import (bottleneck_decode,
                                               bottleneck_encode)

__all__ = ["bottleneck_encode", "bottleneck_decode"]
