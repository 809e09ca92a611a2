"""Offline ingestion: rotated capture segments → replay buffer, exactly once
(the port's counterpart of ``sheeprl_tpu/flywheel/ingest.py``).

The consumption half of the capture hook: stream every
``replica_NNN/capture.jsonl`` segment under a capture root back in
chronological order (the same rotated-segment reader the diag stack uses —
torn trailing lines from a killed replica are counted, never fatal),
deduplicate on ``(session_id, step)`` against a persisted ledger so
re-running ingestion over the same segments is a no-op, stamp every sample
with the ``params_version`` that produced it, and replay the samples into a
:class:`~sheeprl_tpu_torch.data.buffers.ReplayBuffer` through the
:class:`~sheeprl_tpu_torch.engine.RecordingSink` op path — the same
record-then-apply handoff the overlap engine and the actor fleet use, so the
buffer only ever sees single-threaded, production-ordered ``add`` calls.

The ledger (:class:`IngestLedger`, ``ingest_ledger.json`` beside the capture
root) stores one high-water step per ``(session_id, replica, incarnation)``
lineage: capture steps are per-lineage monotonic by construction (capture.py
owns the counter, and a session migrated to another replica — or served by a
respawned incarnation — restarts under a NEW lineage), so "step <=
high-water" IS "already ingested" — compact, crash-safe (atomic replace) and
exact across re-runs, partial runs and segment rotation. The one bounded
edge: a session evicted from a writer's per-session counter LRU
(``capture.max_sessions``, 65536 default) and captured again later restarts
at step 0 under the SAME lineage and is dropped as a duplicate — size the
bound to the concurrent captured-session count.

Buffer layout: one row per sample, ``n_envs=1``. Keys are the obs leaves
(each flattened to a ``float32`` vector — bucketed image policies want a
per-algo finetune step that reshapes, see recipe.py), ``actions``,
``rewards``/``dones``, ``params_version`` and ``capture_step``. Reward
ALIGNMENT: a capture record's own reward/done fields are the client's
report for the lineage's previous action, so row ``t`` takes them from
record ``t+1`` (one record per lineage held until its successor streams
by); a lineage's final record has no successor yet and lands with reward
0.0 (``unrewarded_tails`` counts them). ``trace_id`` is not a buffer
column (strings don't belong in a replay buffer) — the join stats the
benches assert on are computed here and reported in the ingest summary.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..diag.timeline import iter_events, rotated_segments
from ..engine import RecordingSink
from ..fleet.net import _emit

__all__ = ["IngestLedger", "discover_capture_streams", "iter_capture_records", "ingest"]

# one RecordingSink add per chunk: bounds peak memory on a huge backlog
# without paying a per-sample op
_CHUNK_ROWS = 256


class IngestLedger:
    """Persisted exactly-once bookkeeping: high-water capture step per
    ``(session_id, replica, incarnation)`` lineage.

    ``fresh(rec)`` answers "has this sample been ingested before?" without
    storing every key ever seen: capture steps are per-lineage monotonic, so
    one integer per lineage suffices. ``save()`` writes atomically
    (tmp + replace) — a crash mid-save leaves the previous ledger, and the
    worst case is re-reading (and re-deduplicating) already-ledgered
    samples, never double-ingesting."""

    def __init__(self, path: Any) -> None:
        self.path = pathlib.Path(path)
        self.high_water: Dict[str, int] = {}
        self.total_ingested = 0
        if self.path.is_file():
            try:
                raw = json.loads(self.path.read_text())
                self.high_water = {str(k): int(v) for k, v in (raw.get("high_water") or {}).items()}
                self.total_ingested = int(raw.get("total_ingested") or 0)
            except (OSError, ValueError):
                # an unreadable ledger must not brick ingestion: starting
                # empty only risks duplicates, which the buffer tolerates
                # and the ingest summary reports loudly
                self.high_water = {}
                self.total_ingested = 0

    @staticmethod
    def _key(rec: Dict[str, Any]) -> str:
        # the full lineage: replica AND incarnation — two replicas both run
        # incarnation 0, so a session migrated across replicas must not
        # collide with (and be deduped against) its old counter
        return (
            f"{rec.get('session_id')}"
            f"#{int(rec.get('replica') or 0)}"
            f"#{int(rec.get('incarnation') or 0)}"
        )

    def fresh(self, rec: Dict[str, Any]) -> bool:
        key = self._key(rec)
        hw = self.high_water.get(key)
        return hw is None or int(rec.get("step") or 0) > hw

    def mark(self, rec: Dict[str, Any], ingested: bool = True) -> None:
        """Raise the lineage high-water. ``ingested=False`` records a sample
        that was CONSUMED but never reached the buffer (stale-dropped) — the
        high-water still moves (re-runs must not resurface it) but the
        ingested total stays honest."""
        key = self._key(rec)
        step = int(rec.get("step") or 0)
        cur = self.high_water.get(key)
        if cur is None or step > cur:
            self.high_water[key] = step
        if ingested:
            self.total_ingested += 1

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(
            json.dumps({"high_water": self.high_water, "total_ingested": self.total_ingested})
        )
        os.replace(tmp, self.path)


def discover_capture_streams(capture_root: Any) -> List[pathlib.Path]:
    """Every capture stream under the root, one live-path per replica dir
    (rotated segments are resolved by the reader). Accepts either a capture
    root holding ``replica_NNN/`` dirs or a directory that directly holds a
    ``capture.jsonl``."""
    root = pathlib.Path(capture_root)
    out: List[pathlib.Path] = []
    direct = root / "capture.jsonl"
    if rotated_segments(direct):
        out.append(direct)
    if root.is_dir():
        for sub in sorted(root.iterdir()):
            cand = sub / "capture.jsonl"
            if sub.is_dir() and rotated_segments(cand):
                out.append(cand)
    return out


def _latest_attempts(streams: List[pathlib.Path]) -> Dict[str, int]:
    """Trace id → its highest gateway retry ``attempt``, from the records
    that carry one (only lines naming the key are parsed)."""
    latest: Dict[str, int] = {}
    for stream in streams:
        for segment in rotated_segments(stream):
            try:
                with open(segment) as fh:
                    for line in fh:
                        if '"attempt"' not in line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue  # a torn line: the main pass reports it
                        trace = rec.get("trace_id")
                        if rec.get("event") == "capture" and trace:
                            latest[trace] = max(latest.get(trace, 0), int(rec.get("attempt") or 0))
            except OSError:
                continue
    return latest


def iter_capture_records(
    capture_root: Any, errors: Optional[List[str]] = None
) -> Iterator[Dict[str, Any]]:
    """Yield every ``capture`` record under the root, stream by stream,
    oldest segment first within each stream. Rotate markers and any other
    event types are skipped; unparseable (torn) lines land in ``errors``.

    A record whose trace has a record of a later gateway ``attempt`` is
    skipped: the gateway retries an act only after the attempt before it
    got no answer, and acks at most the last one, so the earlier record is
    a step that a replica captured and died before answering."""
    streams = discover_capture_streams(capture_root)
    latest = _latest_attempts(streams)
    for stream in streams:
        for rec in iter_events(stream, errors=errors):
            if rec.get("event") != "capture":
                continue
            if rec.get("session_id") is None or rec.get("step") is None:
                if errors is not None:
                    errors.append(f"{stream}: capture record missing session_id/step")
                continue
            if int(rec.get("attempt") or 0) < latest.get(rec.get("trace_id") or "", 0):
                continue
            yield rec


def _rows_to_ops(rows: List[Dict[str, Any]], sink: RecordingSink) -> None:
    """Pack a chunk of capture records into one [T, 1, ...] add op."""
    t = len(rows)
    data: Dict[str, np.ndarray] = {}
    obs_keys = rows[0]["obs"].keys()
    for key in obs_keys:
        data[key] = np.asarray(
            [np.asarray(r["obs"][key], np.float32).reshape(-1) for r in rows], np.float32
        ).reshape(t, 1, -1)
    data["actions"] = np.asarray(
        [np.asarray(r["actions"], np.float32).reshape(-1) for r in rows], np.float32
    ).reshape(t, 1, -1)
    data["rewards"] = np.asarray(
        [float(r.get("reward") or 0.0) for r in rows], np.float32
    ).reshape(t, 1, 1)
    data["dones"] = np.asarray(
        [1.0 if r.get("done") else 0.0 for r in rows], np.float32
    ).reshape(t, 1, 1)
    data["params_version"] = np.asarray(
        [int(r.get("params_version") or 0) for r in rows], np.int32
    ).reshape(t, 1, 1)
    data["capture_step"] = np.asarray(
        [int(r.get("step") or 0) for r in rows], np.int32
    ).reshape(t, 1, 1)
    sink.add(data)


def ingest(
    capture_root: Any,
    rb: Any,
    ledger: Optional[IngestLedger] = None,
    max_version_lag: Optional[int] = None,
    serving_version: Optional[int] = None,
    emit: Any = None,
    save_ledger: bool = True,
) -> Dict[str, Any]:
    """Stream every fresh capture sample under ``capture_root`` into ``rb``.

    Dedup: a sample whose ``(session_id, replica, incarnation, step)`` is at
    or below the ledger's high-water is counted as a duplicate and skipped —
    re-runs are no-ops. Staleness: with ``max_version_lag`` set, samples
    whose ``params_version`` lags the serving version (``serving_version``
    when given — the recipe resolves it from the gateway's health view —
    else the max version observed in this pass) by MORE than the lag are
    dropped and counted — a sample from a policy ``max_version_lag``
    versions old is still admissible, one more is not.

    Memory is bounded: records stream through dedup → staleness → a
    per-chunk RecordingSink applied immediately (``_CHUNK_ROWS`` rows held
    at a time), so a multi-GB backlog never materializes. When the serving
    version must be INFERRED (``serving_version=None`` with a staleness
    gate), a cheap read-only pre-pass finds the observed max first — double
    I/O, still O(chunk) memory.

    Returns the ingest summary (also emitted as a ``flywheel``/``ingest``
    telemetry event through ``emit`` when given): samples, duplicates,
    dropped_stale, torn_lines, trace-join stats, the admitted version
    spread, and ``version_lag`` — serving version minus the freshest FRESH
    sample (pre-gate, so a backlog dropped entirely as stale still reports
    its true lag and the doctor's flywheel_staleness finding can fire).

    ``save_ledger=False`` skips the durable ledger write (the in-memory
    marks still dedup within this pass): the fine-tune recipe uses it to
    persist consumption only once the new checkpoint has landed, so a crash
    mid-burst re-ingests instead of silently losing the batch.
    """
    t0 = time.monotonic()
    ledger = ledger if ledger is not None else IngestLedger(
        pathlib.Path(capture_root) / "ingest_ledger.json"
    )
    svc_version: Optional[int] = int(serving_version) if serving_version is not None else None
    if svc_version is None and max_version_lag is not None:
        # read-only pre-pass, only when the staleness gate actually needs a
        # reference version before the first drop decision; without a gate
        # the reference is derived from the main pass (no double I/O)
        observed = 0
        for rec in iter_capture_records(capture_root):
            if ledger.fresh(rec):
                observed = max(observed, int(rec.get("params_version") or 0))
        svc_version = observed
    errors: List[str] = []
    duplicates = 0
    dropped_stale = 0
    traced = 0
    samples = 0
    version_min: Optional[int] = None
    version_max: Optional[int] = None
    # the RecordingSink op path: each chunk's ops are recorded then applied
    # in production order — the buffer stays single-threaded (the same
    # handoff contract the overlap engine and fleet merge use) and no more
    # than one chunk of decoded samples (plus one held record per live
    # lineage) is ever held
    pending: List[Dict[str, Any]] = []
    unrewarded_tails = 0

    def flush() -> None:
        nonlocal pending
        if pending:
            sink = RecordingSink()
            _rows_to_ops(pending, sink)
            sink.apply(rb)
            pending = []

    # reward alignment: a capture record's OWN reward/done fields are the
    # client's report for the lineage's PREVIOUS action (the outcome is only
    # known on the next request), so the buffer row for step t takes them
    # from record t+1. One record per lineage is held until its successor
    # arrives; a lineage's final record has no successor this pass and is
    # emitted reward-less (counted — an online-capture boundary).
    held: Dict[str, Dict[str, Any]] = {}

    def emit_row(rec: Dict[str, Any], successor: Optional[Dict[str, Any]]) -> None:
        nonlocal unrewarded_tails
        rec = dict(rec)
        if (
            successor is not None
            and int(successor.get("step") or 0) == int(rec.get("step") or 0) + 1
        ):
            rec["reward"] = successor.get("reward")
            rec["done"] = successor.get("done")
        else:
            rec["reward"] = None
            rec["done"] = None
            unrewarded_tails += 1
        pending.append(rec)
        if len(pending) >= _CHUNK_ROWS:
            flush()

    # the freshest version seen among FRESH (non-duplicate) records, gate
    # or no gate: the lag axis must not go blind exactly when the whole
    # backlog is stale enough to be dropped
    fresh_version_max: Optional[int] = None
    for rec in iter_capture_records(capture_root, errors=errors):
        if not ledger.fresh(rec):
            duplicates += 1
            continue
        v = int(rec.get("params_version") or 0)
        fresh_version_max = v if fresh_version_max is None else max(fresh_version_max, v)
        if max_version_lag is not None and svc_version - v > int(max_version_lag):
            dropped_stale += 1
            # stale samples are still LEDGERED: a re-run must not resurface
            # them as "fresh" and re-drop them forever (but they never
            # count as ingested)
            ledger.mark(rec, ingested=False)
            continue
        if rec.get("trace_id"):
            traced += 1
        version_min = v if version_min is None else min(version_min, v)
        version_max = v if version_max is None else max(version_max, v)
        ledger.mark(rec)
        samples += 1
        key = IngestLedger._key(rec)
        prev = held.pop(key, None)
        if prev is not None:
            emit_row(prev, rec)
        held[key] = rec
    for rec in held.values():
        emit_row(rec, None)
    flush()
    if svc_version is None:
        svc_version = fresh_version_max if fresh_version_max is not None else 0
    if save_ledger:
        ledger.save()
    dt = max(1e-9, time.monotonic() - t0)
    summary: Dict[str, Any] = {
        "samples": samples,
        "duplicates": duplicates,
        "dropped_stale": dropped_stale,
        "torn_lines": len(errors),
        "segments": sum(
            len(rotated_segments(p)) for p in discover_capture_streams(capture_root)
        ),
        "samples_per_s": round(samples / dt, 1),
        "unrewarded_tails": unrewarded_tails,
        "trace_joined": traced,
        "trace_join_frac": round(traced / samples, 4) if samples else 1.0,
        "version_min": version_min if version_min is not None else 0,
        "version_max": version_max if version_max is not None else 0,
        "serving_version": svc_version,
        "version_lag": svc_version
        - (fresh_version_max if fresh_version_max is not None else svc_version),
    }
    _emit(
        emit,
        {
            "event": "flywheel",
            "action": "ingest",
            "samples": summary["samples"],
            "duplicates": summary["duplicates"],
            "dropped_stale": summary["dropped_stale"],
            "torn_lines": summary["torn_lines"],
            "segments": summary["segments"],
            "samples_per_s": summary["samples_per_s"],
            "unrewarded_tails": summary["unrewarded_tails"],
            "version_min": summary["version_min"],
            "version_max": summary["version_max"],
            "serving_version": summary["serving_version"],
            "version_lag": summary["version_lag"],
        },
    )
    return summary
