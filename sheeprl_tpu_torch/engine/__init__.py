"""Execution engines (counterpart of ``sheeprl_tpu/engine``): loop drivers
that decide *when* things run, while the algorithms decide *what* runs."""

from .overlap import BufferOpSink, OverlapEngine, Packet, RecordingSink, SpscRing

__all__ = ["BufferOpSink", "OverlapEngine", "Packet", "RecordingSink", "SpscRing"]
