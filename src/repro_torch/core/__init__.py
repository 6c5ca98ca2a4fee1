"""AVERY core stages (port of ``repro/core``): intent, LUT, packets,
bottleneck, the depth-wise split, the onboard split controller, the LISA
pipeline and the dual-stream executor."""
from repro_torch.core.controller import (MissionGoal, NoFeasibleInsightTier,
                                         PowerConfig, SelectedConfig,
                                         select_configuration)
from repro_torch.core.split import SplitPlan

__all__ = ["SplitPlan", "MissionGoal", "PowerConfig", "SelectedConfig",
           "select_configuration", "NoFeasibleInsightTier"]
