"""Distributed trace context: generation, propagation and span records (the
port's own copy of ``sheeprl_tpu/telemetry/tracing.py``).

* **trace context** — ``(trace_id, span_id, parent_id)``; trace ids are
  32-hex, span ids 16-hex (the W3C Trace Context widths). One trace covers
  one *transition packet* (worker env slice → queue → learner apply) or one
  param publication (learner publish → every worker's apply).
* **traceparent** — the W3C header (``00-<trace>-<span>-01``). Fleet packets
  embed the raw ``(trace_id, span_id)`` pair instead.
* **span records** — the schema'd ``trace_span`` JSONL event
  (:func:`span_record`): name + role + trace ids + wall-clock
  ``t_start``/``t_end``/``dur_ms``. Every process writes spans to its OWN
  stream (:func:`open_process_stream` — ``workers/worker_NNN/`` under the
  run dir, role/pid/incarnation stamped in the startup heartbeat), so the
  streams of a run can be joined on ``trace_id`` afterwards.
* **clock handshake** — the coordinator sends its ``time.time()`` with a
  probe (fleet ctrl-queue ``CTRL_CLOCK``); the child emits a ``clock`` event
  with ``offset_s = t_recv - t_send``. On one host that offset is just
  delivery latency; across hosts it is the skew bound.
* **on-demand profiling** — :class:`RemoteProfiler`: a windowed
  ``torch.profiler`` capture of the process's CPU that a control-plane
  message can trigger (fleet ``CTRL_PROFILE``), with the capture announced on
  the stream as a ``trace`` event.

Span and event names at emit sites are literals: each name is a stage row of
a trace report, and formatted names would make them unbounded.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

__all__ = [
    "TraceContext",
    "child_context",
    "clock_record",
    "make_traceparent",
    "new_span_id",
    "new_trace_id",
    "open_process_stream",
    "parse_traceparent",
    "RemoteProfiler",
    "span_record",
]

TRACEPARENT_VERSION = "00"
_FLAG_SAMPLED = "01"


def new_trace_id() -> str:
    """A fresh 32-hex trace id (uuid4 — unique across processes/hosts)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


class TraceContext(NamedTuple):
    """One span's identity inside a trace."""

    trace_id: str
    span_id: str
    parent_id: str = ""


def child_context(parent: Optional[Tuple[str, str]] = None) -> TraceContext:
    """A new span context: child of ``(trace_id, parent_span_id)`` when a
    parent is given, else the root of a brand-new trace."""
    if parent is not None and parent[0]:
        return TraceContext(str(parent[0]), new_span_id(), str(parent[1]))
    return TraceContext(new_trace_id(), new_span_id(), "")


def make_traceparent(trace_id: str, span_id: str) -> str:
    return f"{TRACEPARENT_VERSION}-{trace_id}-{span_id}-{_FLAG_SAMPLED}"


def parse_traceparent(header: Any) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a traceparent header, or None.

    Strict on the widths and hexness, permissive on version/flags — a
    malformed header from an arbitrary client must start a fresh trace, not
    crash the request path."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def span_record(
    name: str,
    role: str,
    ctx: TraceContext,
    t_start: float,
    t_end: float,
    **extra: Any,
) -> Dict[str, Any]:
    """One schema'd ``trace_span`` JSONL record. ``t_start``/``t_end`` are
    wall-clock (``time.time()``) — cross-process alignment needs one shared
    axis, and the clock handshake corrects the residual skew."""
    rec: Dict[str, Any] = {
        "event": "trace_span",
        "name": str(name),
        "role": str(role),
        "trace_id": ctx.trace_id,
        "span_id": ctx.span_id,
        "t_start": round(float(t_start), 6),
        "t_end": round(float(t_end), 6),
        "dur_ms": round(max(0.0, float(t_end) - float(t_start)) * 1000.0, 4),
    }
    if ctx.parent_id:
        rec["parent_id"] = ctx.parent_id
    rec.update(extra)
    return rec


def clock_record(t_send: float, role: str, **extra: Any) -> Dict[str, Any]:
    """The child's half of the clock handshake: the coordinator's send
    stamp vs this process's receive stamp. ``offset_s`` upper-bounds the
    clock skew (it includes one-way delivery latency, which is why the
    merger ignores offsets below its ``skew_min_s`` floor)."""
    t_recv = time.time()
    rec: Dict[str, Any] = {
        "event": "clock",
        "role": str(role),
        "t_send": round(float(t_send), 6),
        "t_recv": round(t_recv, 6),
        "offset_s": round(t_recv - float(t_send), 6),
    }
    rec.update(extra)
    return rec


def open_process_stream(
    log_dir: Any,
    role: str,
    index: int,
    incarnation: int = 0,
    max_bytes: Optional[int] = None,
    platform: str = "cpu",
    **heartbeat_extra: Any,
) -> Any:
    """Open this process's own telemetry stream under the run dir —
    ``<log_dir>/<role>s/<role>_NNN/telemetry.jsonl`` — and write the
    role/pid/incarnation startup heartbeat as its first event.

    The per-process layout lets a reader find every stream of a run
    without a registry; rotation semantics are the main stream's
    (size-bounded, monotonic segments). ``platform`` is the device the
    process acts on (the fleet's ``worker_platform``)."""
    from .sinks import DEFAULT_JSONL_MAX_BYTES, JsonlSink

    sub = os.path.join(str(log_dir), f"{role}s", f"{role}_{int(index):03d}")
    sink = JsonlSink(
        os.path.join(sub, "telemetry.jsonl"),
        max_bytes=DEFAULT_JSONL_MAX_BYTES if max_bytes is None else int(max_bytes),
    )
    from .memory import host_rss_bytes
    from .schema import SCHEMA_VERSION

    sink.write(
        {
            "event": "startup",
            "platform": str(platform),
            "device_kind": "",
            "devices": 0,
            "rank": int(index),
            "role": str(role),
            "pid": int(os.getpid()),
            "incarnation": int(incarnation),
            "schema_version": SCHEMA_VERSION,
            # host RSS at stream open: every heartbeat carries a memory
            # datum even on CPU-only backends (the mem series baseline)
            "rss_bytes": host_rss_bytes(),
            **heartbeat_extra,
        }
    )
    return sink


class RemoteProfiler:
    """Windowed on-demand ``torch.profiler`` capture of this process's CPU,
    safe to trigger from a control-plane message.

    ``start(duration_s)`` opens a capture and arms the stop deadline; the
    window closes on :meth:`poll` (the fleet worker checks once per slice)
    or on a daemon timer (``use_timer=True``), and :meth:`stop` writes the
    Chrome trace to ``<trace_root>/profile_NNN/trace.json``. A second
    ``start`` while a window is open returns None instead of nesting
    captures, and a profiler that cannot start never takes the process down:
    the capture is best-effort, the acting loop is not."""

    def __init__(
        self,
        trace_root: Any,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
        role: str = "",
    ) -> None:
        self.trace_root = str(trace_root)
        self.emit = emit
        self.role = str(role)
        self._lock = threading.Lock()
        self._active_dir: Optional[str] = None
        self._prof: Any = None
        self._deadline = 0.0
        self._count = 0

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active_dir is not None

    def _emit(self, action: str, trace_dir: str) -> None:
        if self.emit is None:
            return
        try:
            rec = {"event": "trace", "step": 0, "action": action, "trace_dir": trace_dir}
            if self.role:
                rec["role"] = self.role
            self.emit(rec)
        except Exception:
            pass

    def start(self, duration_s: float = 2.0, use_timer: bool = False) -> Optional[str]:
        """Open a capture window; returns its dir, or None when a window is
        already open or the profiler cannot start."""
        with self._lock:
            if self._active_dir is not None:
                return None
            trace_dir = os.path.join(self.trace_root, f"profile_{self._count:03d}")
            try:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CPU])
                prof.start()
            except Exception:
                return None
            self._count += 1
            self._prof = prof
            self._active_dir = trace_dir
            self._deadline = time.monotonic() + max(0.05, float(duration_s))
        self._emit("started", trace_dir)
        if use_timer:
            t = threading.Timer(max(0.05, float(duration_s)), self.stop)
            t.daemon = True
            t.start()
        return trace_dir

    def poll(self) -> None:
        """Close the window if its deadline passed (loop-driven mode)."""
        with self._lock:
            due = self._active_dir is not None and time.monotonic() >= self._deadline
        if due:
            self.stop()

    def stop(self) -> None:
        with self._lock:
            trace_dir, self._active_dir = self._active_dir, None
            prof, self._prof = self._prof, None
        if trace_dir is None:
            return
        try:
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        except Exception:
            pass
        self._emit("stopped", trace_dir)
