"""Serve-side trajectory capture: the flywheel's intake (the port's
counterpart of ``sheeprl_tpu/flywheel/capture.py``).

Every served step a replica acks can become a training sample — this module
is the hook that writes it down instead of dropping it on the floor. A
:class:`CaptureWriter` lives inside the replica process (wired by
``PolicyServer``, see serve/server.py) and appends one schema'd ``capture``
record per sampled act to its OWN segment file
(``<capture_dir>/replica_NNN/capture.jsonl``) through the size-bounded
:class:`~sheeprl_tpu_torch.telemetry.sinks.JsonlSink` — the same monotonic
``.1/.2/…`` rotation + ``rotate`` marker semantics the telemetry stream
uses, so ``flywheel/ingest.py`` streams segments back with the exact reader
the diag stack already trusts (torn trailing lines counted, never fatal).

Record shape (telemetry/schema.py ``capture``):

* ``session_id`` + ``step`` — the dedup axis. ``step`` is a per-session
  monotonic counter maintained HERE, in the replica that served the step;
  ingest deduplicates on ``(session_id, step)`` within the
  ``(replica, incarnation)`` lineage the record carries, so re-ingesting
  the same segments is a no-op while a session migrated to another replica
  (or a respawned incarnation) — whose counter restarts at 0 — is a NEW
  lineage, never deduped against the old one (ingest.py covers the caveat).
* ``trace_id`` — the distributed-tracing id of the gateway request
  that produced this step: every ingested sample joins back to its gateway
  request (and its per-stage latency breakdown in the trace report).
* ``attempt`` — set on a gateway retry (1, 2, …). A replica killed between
  writing a record and sending its answer leaves a record of a step the
  gateway never acked; the gateway replays that step on another replica
  under the same ``trace_id`` and a higher attempt, and
  ``ingest.iter_capture_records`` keeps only a trace's highest attempt.
* ``params_version`` — which policy produced the action: the staleness axis
  the fine-tune recipe's ``max_version_lag`` filters on.
* ``obs`` / ``actions`` / ``reward`` / ``done`` — the sample itself.
  Numbers only: the obs tree and action row are numeric arrays by
  construction (the serve stack validates obs against the warmed template
  before this hook ever sees them) and the optional reward/done are
  client-reported scalars. No headers, no user agent, no free-form client
  fields — the PII boundary is structural, not a scrub pass.

Sampling is **per session**, not per step (``sample_frac``): a stable hash
of the session id decides once whether the whole trajectory is captured, so
captured sessions are contiguous and trainable instead of a confetti of
disconnected steps.

The capture path runs inside the act request, so its cost is act latency:
everything here is one dict build + one JSONL append (the sink's lock +
buffered write). ``chip_smoke.py`` phase gateway measures the act-p95 with
capture on against off.
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np

from ..fleet.net import _emit
from ..telemetry.sinks import JsonlSink

__all__ = ["CaptureWriter", "capture_writer_from_spec", "session_sampled"]

# per-session step counters are LRU-bounded like every other per-session map
# in the serve stack: per-user ids must not leak replica memory
DEFAULT_MAX_SESSIONS = 65536
DEFAULT_MAX_BYTES = 64 * 1024 * 1024


def session_sampled(session_id: str, sample_frac: float) -> bool:
    """Stable per-session coin flip: the same id lands on the same side in
    every replica process (crc32, not ``hash()`` — PYTHONHASHSEED varies
    across spawns), so a migrated session stays captured or stays skipped."""
    if sample_frac >= 1.0:
        return True
    if sample_frac <= 0.0:
        return False
    h = zlib.crc32(str(session_id).encode()) & 0xFFFFFFFF
    return (h / 0x100000000) < sample_frac


class CaptureWriter:
    """Per-replica trajectory capture sink (thread-safe: the HTTP handler
    threads of one PolicyServer all write through it)."""

    def __init__(
        self,
        path: str,
        sample_frac: float = 1.0,
        max_bytes: int = DEFAULT_MAX_BYTES,
        replica_id: int = 0,
        incarnation: int = 0,
        max_sessions: int = DEFAULT_MAX_SESSIONS,
        telem_sink: Any = None,
        log_every_s: float = 10.0,
    ) -> None:
        self.sample_frac = float(sample_frac)
        self.replica_id = int(replica_id)
        self.incarnation = int(incarnation)
        self.max_sessions = int(max_sessions)
        self._sink = JsonlSink(str(path), max_bytes=int(max_bytes) or None)
        self._lock = threading.Lock()
        self._steps: "OrderedDict[str, int]" = OrderedDict()
        self.captured = 0
        self.skipped = 0
        self.errors = 0
        self._bytes_estimate = 0
        # the replica's own telemetry stream: periodic capture_interval
        # snapshots land there so doctor/Prometheus see capture liveness
        self._telem = telem_sink
        self._log_every_s = float(log_every_s)
        self._last_log = time.monotonic()

    @property
    def path(self) -> str:
        return self._sink.path

    def _next_step_locked(self, sid: str) -> int:
        step = self._steps.get(sid, 0)
        self._steps[sid] = step + 1
        self._steps.move_to_end(sid)
        while len(self._steps) > self.max_sessions:
            self._steps.popitem(last=False)
        return step

    def record(
        self,
        session_id: Optional[str],
        obs: Dict[str, Any],
        actions: Any,
        params_version: int,
        trace_id: Optional[str] = None,
        deterministic: bool = False,
        reward: Optional[float] = None,
        done: Optional[bool] = None,
        attempt: Optional[int] = None,
    ) -> bool:
        """Capture one served step; returns True when a record was written.
        Sessionless requests are never captured (no trajectory to join);
        capture failures are counted, never raised — the act path must not
        pay for a full disk with a 500."""
        if session_id is None or not session_sampled(str(session_id), self.sample_frac):
            with self._lock:
                self.skipped += 1
            return False
        sid = str(session_id)
        with self._lock:
            step = self._next_step_locked(sid)
        rec: Dict[str, Any] = {
            "event": "capture",
            "session_id": sid,
            "step": step,
            "obs": {k: np.asarray(v).tolist() for k, v in obs.items()},
            "actions": np.asarray(actions).tolist(),
            "params_version": int(params_version),
            "replica": self.replica_id,
            "incarnation": self.incarnation,
            "deterministic": bool(deterministic),
            "t": round(time.time(), 3),
        }
        if trace_id:
            rec["trace_id"] = str(trace_id)
        if attempt:
            rec["attempt"] = int(attempt)
        # client-reported fields: coerce defensively — a malformed reward
        # must cost the sample its reward, not the act request a 500
        if reward is not None:
            try:
                rec["reward"] = float(reward)
            except (TypeError, ValueError):
                pass
        if done is not None:
            rec["done"] = bool(done)
        try:
            self._sink.write(rec)
        except Exception:
            with self._lock:
                self.errors += 1
            return False
        with self._lock:
            self.captured += 1
        self._maybe_emit_interval()
        return True

    def _maybe_emit_interval(self) -> None:
        if self._telem is None or self._log_every_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_log < self._log_every_s:
                return
            self._last_log = now
            captured, skipped = self.captured, self.skipped
        _emit(
            self._telem.write,
            {
                "event": "flywheel",
                "action": "capture_interval",
                "captured": captured,
                "skipped": skipped,
                "replica": self.replica_id,
            },
        )

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "captured": self.captured,
                "skipped": self.skipped,
                "errors": self.errors,
                "sessions": len(self._steps),
            }

    def close(self) -> None:
        self._sink.close()


def capture_writer_from_spec(
    spec: Dict[str, Any],
    replica_id: int = 0,
    incarnation: int = 0,
    telem_sink: Any = None,
) -> Optional[CaptureWriter]:
    """Build a CaptureWriter from the ``serve.capture`` config node shipped
    in a replica spec (dict form — it crosses a spawn). Returns None when
    capture is disabled or no directory is configured."""
    if not spec or not spec.get("enabled"):
        return None
    root = spec.get("dir")
    if not root:
        return None
    import os

    path = os.path.join(str(root), f"replica_{int(replica_id):03d}", "capture.jsonl")
    return CaptureWriter(
        path,
        sample_frac=float(spec.get("sample_frac", 1.0)),
        max_bytes=int(spec.get("max_bytes", DEFAULT_MAX_BYTES) or 0),
        replica_id=int(replica_id),
        incarnation=int(incarnation),
        max_sessions=int(spec.get("max_sessions", DEFAULT_MAX_SESSIONS)),
        telem_sink=telem_sink,
        log_every_s=float(spec.get("log_every_s", 10.0)),
    )
