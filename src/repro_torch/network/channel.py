"""Simulated uplink channel (host copy of ``repro/network/channel.py``):
serialises packet transmissions against a bandwidth trace. Transmission of a packet occupies the link for
bytes*8 / bw(t) seconds (integrated across trace samples); the channel is
FIFO, single-flow — matching the paper's single-UAV uplink model.

Blackout semantics: trace samples at or below ``blackout_floor_mbps``
carry no usable capacity (disaster traces drop to zero — dividing by the
sample would blow up, and a zero tail would spin forever since
``trace.at`` clamps to the last sample). Dead air accrues instead; after
``blackout_timeout_s`` consecutive dead seconds, or when the trace is
exhausted into a dead tail, the transmission *fails deterministically*:
the record comes back with ``delivered=False`` and ``end_s`` at the
give-up time, so the control policy can defer or retry instead of
hanging the mission loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.core.packets import Packet
from repro_torch.network.traces import BandwidthTrace


@dataclass
class TransmitRecord:
    packet: Packet
    start_s: float
    end_s: float
    delivered: bool = True             # False: gave up in a blackout

    @property
    def latency_s(self) -> float:
        return self.end_s - self.packet.created_at


@dataclass
class Channel:
    trace: BandwidthTrace
    busy_until: float = 0.0
    # below this rate a second is dead air (no partial progress is
    # accumulated against an effectively-down link)
    blackout_floor_mbps: float = 0.05
    # consecutive dead seconds tolerated before the transmission fails
    blackout_timeout_s: float = 30.0
    log: List[TransmitRecord] = field(default_factory=list)
    # transmit-log cap: a long mission (or a chaos storm retrying every
    # frame) must not grow the log without bound — keep the newest
    # ``max_log`` records and count the rest as dropped
    max_log: int = 4096
    n_logged: int = 0

    def measure_bandwidth(self, t: float) -> float:
        """The controller's Sense stage reads the current estimate (the
        paper assumes an onboard bandwidth monitor)."""
        return self.trace.at(t)

    def transmit(self, packet: Packet, now: float) -> TransmitRecord:
        """Send a packet; returns the delivery record. Integrates the
        per-second trace so long transmissions see bandwidth changes;
        terminates on every trace (see the module docstring's blackout
        semantics)."""
        t = max(now, self.busy_until)
        start = t
        remaining_bits = packet.payload_bytes * 8.0
        dead_s = 0.0
        while remaining_bits > 0:
            bw = self.trace.at(t) * 1e6              # bits/s
            # bits transferable until the next whole-second boundary
            boundary = float(int(t) + 1)
            dt = boundary - t
            if bw <= self.blackout_floor_mbps * 1e6:
                # dead interval: past the trace end it stays dead forever
                # (at() clamps), so fail immediately; inside the trace,
                # wait it out up to the timeout
                dead_s += dt
                t = boundary
                if (t >= self.trace.duration_s
                        or dead_s >= self.blackout_timeout_s):
                    return self._record(packet, start, t, delivered=False)
                continue
            dead_s = 0.0
            cap = bw * dt
            if cap >= remaining_bits:
                t += remaining_bits / bw
                remaining_bits = 0.0
            else:
                remaining_bits -= cap
                t = boundary
        return self._record(packet, start, t, delivered=True)

    def _record(self, packet: Packet, start: float, end: float,
                delivered: bool) -> TransmitRecord:
        """The link stays occupied through a failed attempt (the airtime
        was spent), preserving FIFO order for whatever follows."""
        rec = TransmitRecord(packet=packet, start_s=start, end_s=end,
                             delivered=delivered)
        self.busy_until = end
        self.log.append(rec)
        self.n_logged += 1
        if len(self.log) > self.max_log:
            del self.log[:len(self.log) - self.max_log]
        return rec

    @property
    def records_dropped(self) -> int:
        """Transmit records evicted by the ``max_log`` cap."""
        return self.n_logged - len(self.log)
