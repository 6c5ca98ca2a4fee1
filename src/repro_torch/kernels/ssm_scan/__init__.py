from repro_torch.kernels.ssm_scan.ops import chunked_scan

__all__ = ["chunked_scan"]
