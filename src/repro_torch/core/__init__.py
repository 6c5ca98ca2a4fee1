"""AVERY core stages (port of ``repro/core``): intent, LUT, packets,
bottleneck, the LISA pipeline and the dual-stream executor."""
