from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                     paged_decode_attention,
                                                     paged_verify_attention)

__all__ = ["decode_attention", "paged_decode_attention",
           "paged_verify_attention"]
