"""Network simulation (port of ``repro/network``): bandwidth traces, the
simulated FIFO uplink channel, and the analytic edge/cloud device models.
Host-only: numpy and the standard library."""
from repro_torch.network.channel import Channel, TransmitRecord
from repro_torch.network.energy import (EdgeDevice, JETSON_FLOPS,
                                        JETSON_POWER_W, RADIO_J_PER_BIT,
                                        TPU_V5E_FLOPS, TPU_V5E_HBM_BPS,
                                        TPU_V5E_ICI_BPS)
from repro_torch.network.traces import (BandwidthTrace, constant_trace,
                                        paper_trace, random_trace)

__all__ = ["Channel", "TransmitRecord", "BandwidthTrace", "paper_trace",
           "random_trace", "constant_trace", "EdgeDevice",
           "JETSON_FLOPS", "JETSON_POWER_W", "RADIO_J_PER_BIT",
           "TPU_V5E_FLOPS", "TPU_V5E_HBM_BPS", "TPU_V5E_ICI_BPS"]
