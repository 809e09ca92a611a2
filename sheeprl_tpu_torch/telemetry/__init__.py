"""Telemetry of the port's training loops: the JSONL event stream with its
schema, spans, device counters, memory, throughput and MFU behind the
``Telemetry`` facade (the port's own copy of ``sheeprl_tpu/telemetry/``
without its cross-process parts: ``relay.py``, ``tracing.py``'s
per-process streams, ``prof/`` and ``diag/``)."""
