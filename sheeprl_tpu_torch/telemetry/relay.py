"""Telemetry relay: a second, in-band sink that forwards events upstream (the
port's own copy of ``sheeprl_tpu/telemetry/relay.py``).

Every fleet worker keeps writing its own local ``telemetry.jsonl``: that
file is the durable record. The relay is a SECOND sink teeing the same
records toward the learner over the transport the worker already holds
open: a ``T_TELEM`` frame on the socket channel, or a bounded ``telem``
``mp.Queue`` on the one-host channel (``fleet/net.py``,
``fleet/protocol.py``).

The contract that makes this safe to run inside hot loops:

* :meth:`RelaySink.write` NEVER blocks and NEVER raises — it is a sampling
  check plus a bounded ``deque.append``; when the buffer is full the event
  is counted in ``dropped`` and forgotten (the local file still has it);
* flushes are cadence-driven and size-capped (``max_batch_bytes``); the
  transport send callable itself is bounded (socket sends carry a deadline,
  mp puts are ``put_nowait``) and a failed send counts the batch as dropped
  instead of retrying;
* relayed events are *advisory*: the files stay the source of truth.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["RelaySink", "TeeSink", "http_post_sender"]

DEFAULT_MAX_BUFFER = 512
DEFAULT_MAX_BATCH_BYTES = 64 * 1024
DEFAULT_FLUSH_S = 2.0

# high-rate event types the sample knob thins; everything else (incidents,
# heartbeats, interval stats) is low-rate and always relayed
_SAMPLED_EVENTS = {"trace_span", "metrics"}


class RelaySink:
    """Bounded, sampled, drop-counted event forwarder.

    ``send(batch: dict) -> bool`` is the transport hook: it receives
    ``{"role", "index", "events", "dropped"}`` and returns False when the
    batch could not be handed to the transport (the events are then counted
    as dropped — never retried, never buffered again).
    """

    def __init__(
        self,
        send: Callable[[Dict[str, Any]], bool],
        role: str,
        index: int = 0,
        sample: float = 1.0,
        max_buffer: int = DEFAULT_MAX_BUFFER,
        max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
        flush_s: float = DEFAULT_FLUSH_S,
    ) -> None:
        self._send = send
        self.role = str(role)
        self.index = int(index)
        self.sample = min(1.0, max(0.0, float(sample)))
        self.max_buffer = max(1, int(max_buffer))
        self.max_batch_bytes = max(1024, int(max_batch_bytes))
        self.flush_s = max(0.05, float(flush_s))
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._sample_tick = 0
        self._last_flush = time.monotonic()
        self.sent = 0
        self.dropped = 0
        self.batches = 0

    # -- hot path ----------------------------------------------------------
    def write(self, rec: Dict[str, Any]) -> None:
        """Enqueue one event; O(1), non-blocking, exception-free."""
        try:
            if self.sample < 1.0 and rec.get("event") in _SAMPLED_EVENTS:
                # deterministic counter sampling: keep 1 in round(1/sample)
                self._sample_tick += 1
                keep_every = max(1, int(round(1.0 / self.sample))) if self.sample > 0 else 0
                if keep_every == 0 or self._sample_tick % keep_every != 0:
                    return
            with self._lock:
                if len(self._buf) >= self.max_buffer:
                    self.dropped += 1
                    return
                self._buf.append(rec)
        except Exception:
            pass

    def maybe_flush(self) -> None:
        """Flush when the cadence elapsed — the loop-driven entry point."""
        if time.monotonic() - self._last_flush >= self.flush_s:
            self.flush()

    # -- flush path --------------------------------------------------------
    def _take_batch(self) -> List[Dict[str, Any]]:
        """Drain up to ``max_batch_bytes`` worth of events (approximate:
        byte size is estimated from the JSON field count, the transport
        re-caps on encode)."""
        import json

        out: List[Dict[str, Any]] = []
        size = 0
        with self._lock:
            while self._buf:
                rec = self._buf[0]
                try:
                    nbytes = len(json.dumps(rec))
                except (TypeError, ValueError):
                    self._buf.popleft()
                    self.dropped += 1
                    continue
                if out and size + nbytes > self.max_batch_bytes:
                    break
                self._buf.popleft()
                out.append(rec)
                size += nbytes
        return out

    def flush(self) -> int:
        """Send everything buffered (in size-capped batches); returns the
        number of events that made it onto the transport."""
        self._last_flush = time.monotonic()
        total = 0
        while True:
            batch = self._take_batch()
            if not batch:
                break
            payload = {
                "role": self.role,
                "index": self.index,
                "events": batch,
                "dropped": self.dropped,
            }
            ok = False
            try:
                ok = bool(self._send(payload))
            except Exception:
                ok = False
            if ok:
                self.sent += len(batch)
                self.batches += 1
                total += len(batch)
            else:
                # the transport refused the batch: count and move on — the
                # local file has the events, blocking/retrying here would
                # put backpressure on the hot path the relay must never add
                self.dropped += len(batch)
                break
        return total

    def stats_record(self) -> Dict[str, Any]:
        """A schema'd ``relay`` accounting event for the local stream."""
        rec: Dict[str, Any] = {
            "event": "relay",
            "role": self.role,
            "index": self.index,
            "sent": int(self.sent),
            "dropped": int(self.dropped),
            "batches": int(self.batches),
        }
        return rec

    def close(self) -> None:
        self.flush()


class TeeSink:
    """One sink façade over (local JSONL, optional relay).

    The primary sink keeps exact pre-relay semantics (validation,
    rotation); the relay side is attachable after construction (a worker's
    channel exists only after its stream was opened). The periodic relay
    flush rides the write path (``maybe_flush`` per write), so no extra
    thread is needed in loop-driven processes.

    A ``None`` primary is allowed: a remote worker attached WITHOUT a local
    ``--log-dir`` used to produce no telemetry at all — with the relay it
    still streams events upstream, it just has no durable local copy.
    """

    def __init__(self, primary: Any = None, relay: Optional[RelaySink] = None) -> None:
        self.primary = primary
        self.relay = relay
        self._stats_every = 50  # writes between relay-stats self-reports
        self._writes = 0

    @property
    def path(self) -> Any:  # JsonlSink API passthrough (tests, doctor)
        return getattr(self.primary, "path", None)

    def attach_relay(self, relay: RelaySink) -> None:
        self.relay = relay

    def write(self, rec: Dict[str, Any]) -> None:
        if self.primary is not None:
            self.primary.write(rec)
        relay = self.relay
        if relay is None:
            return
        relay.write(rec)
        relay.maybe_flush()
        self._writes += 1
        if (
            self.primary is not None
            and self._writes % self._stats_every == 0
            and (relay.sent or relay.dropped)
        ):
            # the accounting event goes to the local file only — relaying
            # relay stats about themselves would recurse
            try:
                self.primary.write(relay.stats_record())
            except Exception:
                pass

    def close(self) -> None:
        relay = self.relay
        if relay is not None:
            try:
                relay.flush()
                if self.primary is not None and (relay.sent or relay.dropped):
                    self.primary.write(relay.stats_record())
            except Exception:
                pass
        if self.primary is not None:
            self.primary.close()


def http_post_sender(url: str, timeout_s: float = 2.0) -> Callable[[Dict[str, Any]], bool]:
    """A RelaySink ``send`` callable POSTing JSON batches to ``url`` (the
    gateway's ``/admin/telemetry`` or any compatible ingest endpoint)."""
    import json
    import urllib.request

    def send(batch: Dict[str, Any]) -> bool:
        body = json.dumps(batch).encode()
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return 200 <= resp.status < 300
        except Exception:
            return False

    return send
