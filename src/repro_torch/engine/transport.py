"""Transport plug point: how packets cross the edge/cloud boundary (host
copy of ``repro/engine/transport.py``).

The engine is transport-agnostic: it senses bandwidth and hands packets
to a ``Transport``; what happens on the wire is an implementation.
Two implementations ship:

  * ``ChannelTransport`` — the paper's simulated FIFO uplink
    (``network.Channel`` against a bandwidth trace); delivery time
    integrates the per-second trace, and the transmit log feeds the
    latency telemetry.
  * ``LoopbackTransport`` — in-process zero-delay link for benchmarks and
    tests: constant sensed bandwidth, instant delivery. Swapping it in
    removes the network from a measurement without touching the loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Protocol, runtime_checkable

from repro_torch.core.packets import Packet
from repro_torch.network.channel import Channel, TransmitRecord
from repro_torch.network.traces import BandwidthTrace


@runtime_checkable
class Transport(Protocol):
    """Minimal link contract: sense + send."""

    def bandwidth(self, t: float) -> float:
        """Sensed uplink bandwidth (Mbps) at mission time ``t`` — the
        controller's Sense stage."""
        ...

    def send(self, packet: Packet, t: float) -> TransmitRecord:
        """Put ``packet`` on the link at time ``t``; returns the delivery
        record (start_s/end_s in mission time)."""
        ...


@dataclass
class ChannelTransport:
    """Simulated uplink: a FIFO ``Channel`` over a bandwidth trace."""
    channel: Channel

    @classmethod
    def from_trace(cls, trace: BandwidthTrace) -> "ChannelTransport":
        return cls(Channel(trace))

    def bandwidth(self, t: float) -> float:
        return self.channel.measure_bandwidth(t)

    def send(self, packet: Packet, t: float) -> TransmitRecord:
        return self.channel.transmit(packet, t)

    @property
    def records(self) -> List[TransmitRecord]:
        return self.channel.log

    @property
    def records_dropped(self) -> int:
        return self.channel.records_dropped


@dataclass
class LoopbackTransport:
    """In-process link: constant sensed bandwidth, instant delivery."""
    bandwidth_mbps: float = 1000.0
    records: List[TransmitRecord] = field(default_factory=list)
    # same bound as Channel.max_log: benchmarks loop this transport for
    # thousands of sends and must not accumulate records without bound
    max_records: int = 4096
    n_sent: int = 0

    def bandwidth(self, t: float) -> float:
        return self.bandwidth_mbps

    def send(self, packet: Packet, t: float) -> TransmitRecord:
        rec = TransmitRecord(packet=packet, start_s=t, end_s=t)
        self.records.append(rec)
        self.n_sent += 1
        if len(self.records) > self.max_records:
            del self.records[:len(self.records) - self.max_records]
        return rec

    @property
    def records_dropped(self) -> int:
        return self.n_sent - len(self.records)
