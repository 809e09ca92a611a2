"""The telemetry event schema: one JSON object per line (JSONL).

The port's own copy of ``sheeprl_tpu/telemetry/schema.py`` for the event
types the port emits (``startup``, ``log``, ``shutdown``, ``metrics``,
``trace``, ``rotate``, ``overlap``, ``ckpt_async``, ``preempt``,
``resume``, ``mem``, ``roofline``). Field names and types are the
reference's, letter for letter, so the JAX package's ``validate_jsonl``
accepts a port run's ``telemetry.jsonl``. Every record is
``{"event": <type>, ...}``; required keys and types are checked per event
type, and unknown extra keys are allowed (the port adds a few, e.g. the
``log`` record's ``device`` counters).
"""
from __future__ import annotations

import json
import numbers
from typing import Any, Dict, List, Tuple

SCHEMA_VERSION = 1

_NUM = numbers.Number
_STR = str
_DICT = dict

# event type -> {field: (required, type)}
EVENT_SCHEMAS: Dict[str, Dict[str, Tuple[bool, type]]] = {
    # once at Telemetry.setup: the platform the run is on, so a run on the
    # host is never silent about it
    "startup": {
        "platform": (True, _STR),
        "device_kind": (True, _STR),
        "devices": (True, _NUM),
        "rank": (True, _NUM),
        "world_size": (False, _NUM),
        "algo": (False, _STR),
        "run_name": (False, _STR),
        "schema_version": (False, _NUM),
        "role": (False, _STR),
        "pid": (False, _NUM),
        "incarnation": (False, _NUM),
        "worker": (False, _NUM),
        "replica": (False, _NUM),
        "rss_bytes": (False, _NUM),
    },
    # one per log interval
    "log": {
        "step": (True, _NUM),
        "sps": (False, _NUM),
        "metrics": (False, _DICT),
        "spans": (False, _DICT),
        "xla": (False, _DICT),
        "memory": (False, _DICT),
        "throughput": (False, _DICT),
    },
    # end-of-run summary
    "shutdown": {
        "step": (True, _NUM),
        "xla": (False, _DICT),
        "spans": (False, _DICT),
        "total_grad_steps": (False, _NUM),
    },
    # the TensorBoard logger's fallback stream (metrics are never dropped)
    "metrics": {
        "step": (True, _NUM),
        "metrics": (True, _DICT),
    },
    # windowed profiler capture markers (metric.telemetry.trace_every)
    "trace": {
        "step": (True, _NUM),
        "action": (True, _STR),  # started | stopped
        "trace_dir": (False, _STR),
        "role": (False, _STR),
        "worker": (False, _NUM),
        "replica": (False, _NUM),
    },
    # the first record of a fresh segment after a size-bounded roll
    "rotate": {
        "segment": (True, _NUM),
        "path": (False, _STR),
        "bytes": (False, _NUM),
    },
    "preempt": {
        "step": (True, _NUM),
        "action": (True, _STR),  # requested | checkpointed | flush_timeout
        "signal": (False, _STR),
        "grace_s": (False, _NUM),
    },
    "ckpt_async": {
        "action": (True, _STR),  # enqueued | written | failed
        "step": (True, _NUM),
        "block_ms": (False, _NUM),
        "write_ms": (False, _NUM),
        "bytes": (False, _NUM),
        "path": (False, _STR),
        "in_flight": (False, _NUM),
        "mode": (False, _STR),  # async | sync
    },
    # the overlap engine's interval record
    "overlap": {
        "step": (True, _NUM),
        "player_step": (False, _NUM),
        "queue_depth": (False, _NUM),
        "queue_cap": (False, _NUM),
        "packets": (False, _NUM),
        "bursts": (False, _NUM),
        "env_steps_ahead": (False, _NUM),
        "player_busy_s": (False, _NUM),
        "player_stall_s": (False, _NUM),
        "learner_stall_s": (False, _NUM),
        "player_stall_frac": (False, _NUM),
        "staleness_max": (False, _NUM),
        "interval_s": (False, _NUM),
    },
    "resume": {
        "step": (True, _NUM),
        "checkpoint": (False, _STR),
        "run_dir": (False, _STR),
        "fingerprint": (False, _STR),
    },
    # a jittered-backoff retry of a transient operation (resilience/supervisor.py)
    "retry": {
        "op": (True, _STR),
        "attempt": (True, _NUM),
        "error": (False, _STR),
        "sleep_s": (False, _NUM),
    },
    # the stalled-progress watchdog (resilience/supervisor.py): `incident` is
    # the run's incident counter, `trace_dir` the incident's own torch.profiler
    # capture (where there is none, an undeclared `trace_error` says why)
    "watchdog": {
        "action": (True, _STR),  # stall | preempt
        "step": (False, _NUM),
        "stalled_s": (False, _NUM),
        "trace_dir": (False, _STR),
        "incident": (False, _NUM),
    },
    # host RSS always, device memory where there is a device
    "mem": {
        "role": (True, _STR),
        "rss_bytes": (True, _NUM),
        "t": (False, _NUM),
        "step": (False, _NUM),
        "rss_peak_bytes": (False, _NUM),
        "hbm_bytes_in_use": (False, _NUM),
        "hbm_peak_bytes": (False, _NUM),
        "hbm_bytes_limit": (False, _NUM),
        "live_buffers": (False, _NUM),
        "live_buffer_bytes": (False, _NUM),
        "worker": (False, _NUM),
        "replica": (False, _NUM),
        "index": (False, _NUM),
    },
    # a function's operations and bytes against the card's two roofs
    "roofline": {
        "fn": (True, _STR),
        "flops": (True, _NUM),
        "bytes_accessed": (True, _NUM),
        "intensity": (True, _NUM),
        "bound": (True, _STR),  # compute | memory | unknown
        "ridge_intensity": (False, _NUM),
        "peak_flops": (False, _NUM),
        "peak_bytes_per_s": (False, _NUM),
        "attained_frac": (False, _NUM),
        "attained_flops_per_s": (False, _NUM),
        "calls_per_s": (False, _NUM),
        "device_kind": (False, _STR),
        "basis": (False, _STR),
        "role": (False, _STR),
        "step": (False, _NUM),
        "t": (False, _NUM),
    },
}


def validate_event(rec: Any) -> List[str]:
    """The problems of one record (empty when it is valid)."""
    errors: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, expected dict"]
    event = rec.get("event")
    if not isinstance(event, str):
        return ["missing 'event' field"]
    schema = EVENT_SCHEMAS.get(event)
    if schema is None:
        return [f"unknown event type {event!r} (known: {sorted(EVENT_SCHEMAS)})"]
    for field, (required, typ) in schema.items():
        if field not in rec:
            if required:
                errors.append(f"{event}: missing required field '{field}'")
            continue
        val = rec[field]
        if typ is _NUM and isinstance(val, bool):
            errors.append(f"{event}: field '{field}' is bool, expected number")
        elif not isinstance(val, typ):
            errors.append(f"{event}: field '{field}' is {type(val).__name__}, expected {typ.__name__}")
    return errors


def validate_jsonl(path: Any) -> List[str]:
    """The problems of a whole JSONL file, line by line."""
    errors: List[str] = []
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as err:
                errors.append(f"line {i}: not JSON ({err})")
                continue
            errors.extend(f"line {i}: {e}" for e in validate_event(rec))
    return errors
