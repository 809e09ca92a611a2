"""The telemetry event schema: one JSON object per line (JSONL).

The port's own copy of ``sheeprl_tpu/telemetry/schema.py`` for the event
types the port emits (``startup``, ``log``, ``shutdown``, ``metrics``,
``trace``, ``rotate``, ``overlap``, ``ckpt_async``, ``preempt``,
``resume``, ``mem``, ``roofline``, and the actor fleet's ``fleet``,
``net``, ``chaos``, ``trace_span``, ``clock`` and ``relay``, the
serving stack's ``serve``, ``reload`` and ``session``, the serving
plane's ``replica``, ``gateway`` and ``broker``, the data flywheel's
``capture`` and ``flywheel``, the live aggregator's ``alert``, and the
mesh layout's ``sharding``). Field names and types are the
reference's, letter for letter, so the JAX package's ``validate_jsonl``
accepts a port run's ``telemetry.jsonl``. Every record is
``{"event": <type>, ...}``; required keys and types are checked per event
type, and unknown extra keys are allowed (the port adds a few, e.g. the
``log`` record's ``device`` counters and a retried ``capture``'s
``attempt``).
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
        # the card's health at the end (Telemetry.device_health)
        "device": (False, _DICT),
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
    # one distributed-tracing span (telemetry/tracing.py span_record): a
    # named stage of a training round's path (worker env step, queue wait,
    # learner apply) or of a param publication (publish, param_apply)
    "trace_span": {
        "name": (True, _STR),
        "role": (True, _STR),  # worker | learner
        "trace_id": (True, _STR),
        "span_id": (True, _STR),
        "t_start": (True, _NUM),
        "t_end": (True, _NUM),
        "dur_ms": (True, _NUM),
        "parent_id": (False, _STR),
        "step": (False, _NUM),
        "seq": (False, _NUM),
        "version": (False, _NUM),
        "worker": (False, _NUM),
        "replica": (False, _NUM),
        "session_id": (False, _STR),
        "detail": (False, _STR),
    },
    # clock-offset handshake (telemetry/tracing.py clock_record): the
    # learner's probe send time against this process's receive time
    "clock": {
        "role": (True, _STR),
        "t_send": (True, _NUM),
        "t_recv": (True, _NUM),
        "offset_s": (True, _NUM),
        "worker": (False, _NUM),
        "replica": (False, _NUM),
    },
    # actor-fleet supervision (fleet/): `action` is a discrete incident
    # (spawn | respawn | crash | hang | torn_packet | stale_packet |
    # disconnect | quarantine | republish | profile | await_attach | drain)
    # with per-worker fields, or "interval", the periodic liveness snapshot.
    # `dropped_steps` counts env steps that never landed learner-side.
    "fleet": {
        "action": (True, _STR),
        "step": (True, _NUM),
        "worker": (False, _NUM),
        "incarnation": (False, _NUM),
        "pid": (False, _NUM),
        "exitcode": (False, _NUM),
        "fails_in_window": (False, _NUM),
        "detail": (False, _STR),
        "workers": (False, _NUM),
        "alive": (False, _NUM),
        "quarantined": (False, _NUM),
        "respawns": (False, _NUM),
        "crashes": (False, _NUM),
        "hangs": (False, _NUM),
        "torn_packets": (False, _NUM),
        "rounds": (False, _NUM),
        "queue_depth_max": (False, _NUM),
        "env_steps": (False, _NUM),
        "drain_dropped": (False, _NUM),
        "dropped_steps": (False, _NUM),
        "round_wait_s": (False, _NUM),
        "interval_s": (False, _NUM),
        "reconnects": (False, _NUM),
        "dup_frames": (False, _NUM),
        "disconnects": (False, _NUM),
        "relay_dropped": (False, _NUM),
        "act_mode": (False, _STR),
        "act_requests": (False, _NUM),
        "act_batches": (False, _NUM),
        "act_occupancy": (False, _NUM),
        "act_pad_waste": (False, _NUM),
        "act_sessions": (False, _NUM),
        "act_version": (False, _NUM),
    },
    # socket-transport link lifecycle (fleet/net.py): learner events (listen
    # | accept | reconnect | refuse | disconnect | resync | dup_frame |
    # gap_resend | write_timeout | pull) on the run stream, worker events
    # (connect | connect_backoff | disconnect | resend | partition |
    # chaos_reset | refused) on the worker's own stream
    "net": {
        "action": (True, _STR),
        "worker": (False, _NUM),
        "incarnation": (False, _NUM),
        "seq": (False, _NUM),
        "version": (False, _NUM),
        "count": (False, _NUM),
        "bytes": (False, _NUM),
        "detail": (False, _STR),
    },
    # faults the fleet supervisor injects (resilience/chaos.py); the
    # worker-side ones surface as `fleet` incidents
    "chaos": {
        "fault": (True, _STR),  # dropped_publication | armed
        "worker": (False, _NUM),
        "seq": (False, _NUM),
        "detail": (False, _STR),
    },
    # relay flush accounting (telemetry/relay.py) on the emitting process's
    # own stream; `sent` and `dropped` are cumulative
    "relay": {
        "role": (True, _STR),
        "sent": (True, _NUM),
        "dropped": (True, _NUM),
        "batches": (True, _NUM),
        "worker": (False, _NUM),
        "replica": (False, _NUM),
        "index": (False, _NUM),
        "detail": (False, _STR),
    },
    # policy-serving stat snapshot (serve/batcher.py): queue depth, batch
    # occupancy, latency percentiles, retrace/reload counters
    "serve": {
        "requests": (True, _NUM),
        "completed": (False, _NUM),
        "rejected": (False, _NUM),
        "errors": (False, _NUM),
        "evictions": (False, _NUM),
        "expired": (False, _NUM),
        "batches": (False, _NUM),
        "queue_depth": (False, _NUM),
        "batch_occupancy": (False, _NUM),
        "avg_batch_size": (False, _NUM),
        "p50_ms": (False, _NUM),
        "p95_ms": (False, _NUM),
        "p99_ms": (False, _NUM),
        "retraces": (False, _NUM),
        "reloads": (False, _NUM),
        "params_version": (False, _NUM),
        "sessions": (False, _NUM),
        # padded-row fraction of dispatched buckets (mean over batches)
        "pad_waste": (False, _NUM),
    },
    # checkpoint hot-reload attempts (serve/reload.py)
    "reload": {
        "action": (True, _STR),  # swapped | failed
        "path": (False, _STR),
        "step": (False, _NUM),
        "params_version": (False, _NUM),
        "error": (False, _STR),
    },
    # per-session serving lifecycle (serve/batcher.py): an LRU eviction
    "session": {
        "action": (True, _STR),  # evicted
        "session_id": (False, _STR),
        "detail": (False, _STR),
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
        "snapshot_ms": (False, _NUM),  # the device-to-host copy of the state
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
        "learner_stall_frac": (False, _NUM),
        "staleness_max": (False, _NUM),
        "interval_s": (False, _NUM),
        "staleness_seen_max": (False, _NUM),  # the run's largest staleness so far
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
    # an SLO burn rule's transition (diag/aggregator.py), on the main stream
    # the session broker (gateway/wal.py, brokerd.py, broker_client.py):
    # primary/standby lifecycle, WAL recovery and the daemon's interval
    # snapshot (`action`: promote | fenced | demote | zombie | repl_timeout |
    # wal_torn_tail | wal_rehydrate | rehydrate_failed | compact |
    # client_reconnect | client_failover | client_partition | interval ...)
    "broker": {
        "action": (True, _STR),
        "role": (False, _STR),  # primary | standby | demoted
        "epoch": (False, _NUM),  # the fencing token
        "seq": (False, _NUM),  # WAL sequence number
        "version": (False, _NUM),
        "sessions": (False, _NUM),
        "puts": (False, _NUM),
        "gets": (False, _NUM),
        "fenced_writes": (False, _NUM),
        "standbys": (False, _NUM),
        "lag": (False, _NUM),  # replication lag high-water (records)
        "count": (False, _NUM),
        "bytes": (False, _NUM),
        "promotion_s": (False, _NUM),
        "repl_wait_p95_ms": (False, _NUM),
        "fsync_p95_ms": (False, _NUM),
        "detail": (False, _STR),
    },
    # one served step captured by the data flywheel (flywheel/capture.py),
    # written to the replica's own capture segments, not the telemetry
    # stream; numbers only (the obs tree and the action row)
    "capture": {
        "session_id": (True, _STR),
        "step": (True, _NUM),
        "obs": (True, _DICT),
        "actions": (True, list),
        "params_version": (True, _NUM),
        "trace_id": (False, _STR),
        "replica": (False, _NUM),
        "incarnation": (False, _NUM),
        "deterministic": (False, bool),
        "reward": (False, _NUM),
        "done": (False, bool),
        "t": (False, _NUM),
    },
    # data-flywheel lifecycle (flywheel/): capture_interval | ingest |
    # dropped_stale | finetune | reload
    "flywheel": {
        "action": (True, _STR),
        "samples": (False, _NUM),
        "duplicates": (False, _NUM),
        "torn_lines": (False, _NUM),
        "segments": (False, _NUM),
        "captured": (False, _NUM),
        "skipped": (False, _NUM),
        "bytes": (False, _NUM),
        "dropped_stale": (False, _NUM),
        "samples_per_s": (False, _NUM),
        "unrewarded_tails": (False, _NUM),
        "version_min": (False, _NUM),
        "version_max": (False, _NUM),
        "serving_version": (False, _NUM),
        "version_lag": (False, _NUM),
        "steps": (False, _NUM),
        "step": (False, _NUM),
        "params_version": (False, _NUM),
        "replica": (False, _NUM),
        "loss": (False, _NUM),
        "detail": (False, _STR),
        "t": (False, _NUM),
    },
    # serving-replica supervision (gateway/replica.py): spawn | respawn |
    # ready | crash | hang | quarantine | drain | reload
    "replica": {
        "action": (True, _STR),
        "replica": (False, _NUM),
        "incarnation": (False, _NUM),
        "pid": (False, _NUM),
        "port": (False, _NUM),
        "fails_in_window": (False, _NUM),
        "params_version": (False, _NUM),
        "detail": (False, _STR),
    },
    # the gateway's stat snapshot (gateway/gateway.py)
    "gateway": {
        "requests": (True, _NUM),
        "acked": (False, _NUM),
        "errors": (False, _NUM),
        "failovers": (False, _NUM),
        "migrations": (False, _NUM),
        "rehydrates": (False, _NUM),
        "expired": (False, _NUM),
        "lost": (False, _NUM),
        "retries": (False, _NUM),
        "broker_unavailable": (False, _NUM),
        "p50_ms": (False, _NUM),
        "p95_ms": (False, _NUM),
        "p99_ms": (False, _NUM),
        "replicas": (False, _NUM),
        "routable": (False, _NUM),
        "quarantined": (False, _NUM),
        "respawns": (False, _NUM),
        "sessions": (False, _NUM),
        "broker_sessions": (False, _NUM),
        "admission_inflight": (False, _NUM),
        "admission_admitted": (False, _NUM),
        "admission_shed": (False, _NUM),
        "admission_shed_low": (False, _NUM),
        "admission_tokens": (False, _NUM),
    },
    "alert": {
        "rule": (True, _STR),
        "state": (True, _STR),  # firing | resolved
        "metric": (True, _STR),
        "value": (False, _NUM),
        "threshold": (False, _NUM),
        "burn_frac": (False, _NUM),
        "window_s": (False, _NUM),
        "severity": (False, _STR),  # critical | warning
        "detail": (False, _STR),
    },
    # one decision of the mesh's rule engine (parallel/sharding.py): a
    # parameter or optimizer-state leaf's spec, rule, reason and bytes per
    # rank ("leaf"), or a tree's totals ("summary"); dp/fsdp/tp are the axis
    # sizes; doctor's replicated_giant reads the leaves
    "sharding": {
        "action": (True, _STR),  # leaf | summary
        "group": (False, _STR),  # params | opt_state
        "path": (False, _STR),
        "shape": (False, list),
        "spec": (False, _STR),
        "rule": (False, _STR),
        "reason": (False, _STR),
        "bytes": (False, _NUM),
        "bytes_per_chip": (False, _NUM),
        "dp": (False, _NUM),
        "fsdp": (False, _NUM),
        "tp": (False, _NUM),
        "leaves": (False, _NUM),
        "replicated_leaves": (False, _NUM),
        "total_bytes": (False, _NUM),
        "replicated_bytes": (False, _NUM),
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
