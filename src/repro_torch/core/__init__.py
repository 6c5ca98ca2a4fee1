"""AVERY core stages (port of ``repro/core``): intent, LUT, packets,
bottleneck, the depth-wise split, the LISA pipeline and the dual-stream
executor."""
from repro_torch.core.split import SplitPlan

__all__ = ["SplitPlan"]
