"""Network simulation (port of ``repro/network``): bandwidth traces, the
simulated FIFO uplink channel, and the analytic edge/cloud device models.
Host-only: numpy and the standard library."""
from repro_torch.network.channel import Channel, TransmitRecord
from repro_torch.network.energy import (H100_FLOPS, H100_HBM_BPS,
                                        H100_POWER_W, H100_SXM, JETSON_FLOPS,
                                        JETSON_POWER_W, RADIO_J_PER_BIT,
                                        TPU_V5E_FLOPS, TPU_V5E_HBM_BPS,
                                        TPU_V5E_ICI_BPS, CloudDevice,
                                        EdgeDevice)
from repro_torch.network.traces import (BandwidthTrace, constant_trace,
                                        paper_trace, random_trace)

__all__ = ["Channel", "TransmitRecord", "BandwidthTrace", "paper_trace",
           "random_trace", "constant_trace", "EdgeDevice", "CloudDevice",
           "H100_SXM", "H100_FLOPS", "H100_HBM_BPS", "H100_POWER_W",
           "JETSON_FLOPS", "JETSON_POWER_W", "RADIO_J_PER_BIT",
           "TPU_V5E_FLOPS", "TPU_V5E_HBM_BPS", "TPU_V5E_ICI_BPS"]
