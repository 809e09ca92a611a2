"""Telemetry sinks: the JSONL event stream and the console heartbeat (the
port's own copy of ``sheeprl_tpu/telemetry/sinks.py``). The TensorBoard
sink is ``utils/logger.py``, handed to the facade.
"""
from __future__ import annotations

import json
import os
import sys
import threading
from typing import IO, Any, Callable, Dict, Optional

from .schema import validate_event

DEFAULT_JSONL_MAX_BYTES = 256 * 1024 * 1024  # a week-long run must not fill the disk


def _render_event(rec: Dict[str, Any], strict: bool = False) -> str:
    """Validate and serialize one event to its JSONL line. An invalid record
    is written anyway with a note on stderr (telemetry never stops a run)
    unless ``strict``."""
    errors = validate_event(rec)
    if errors:
        if strict:
            raise ValueError(f"invalid telemetry event: {errors}")
        print(f"[telemetry] schema warning: {errors}", file=sys.stderr)
    return json.dumps(rec) + "\n"


def write_event(rec: Dict[str, Any], stream: Optional[IO[str]] = None, strict: bool = False) -> Dict[str, Any]:
    """Validate and write one event as a single JSONL line (stdout by default)."""
    out = stream if stream is not None else sys.stdout
    out.write(_render_event(rec, strict))
    out.flush()
    return rec


class JsonlSink:
    """Append-only JSONL event file (thread-safe) with size-bounded rotation.

    Past ``max_bytes`` the live file rolls to ``<path>.<n>``, n a monotonic
    segment index (``telemetry.jsonl.1`` is the oldest: numeric order is
    chronological order), and the fresh file opens with a ``rotate`` record
    naming the segment it closed. ``max_bytes`` 0 or None never rolls."""

    def __init__(self, path: str, max_bytes: Optional[int] = DEFAULT_JSONL_MAX_BYTES,
                 on_rotate: Optional[Callable[[Dict[str, Any]], None]] = None) -> None:
        self.path = path
        self.max_bytes = int(max_bytes or 0)
        self.on_rotate = on_rotate
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._fh: Optional[IO[str]] = open(path, "a")
        self._size = os.path.getsize(path)
        self._segment = self._next_segment_index()

    def _next_segment_index(self) -> int:
        """1 + the highest rotated index there is (a resumed run rolls on
        where the last process stopped)."""
        prefix = os.path.basename(self.path) + "."
        found = [int(n[len(prefix):]) for n in os.listdir(os.path.dirname(self.path) or ".")
                 if n.startswith(prefix) and n[len(prefix):].isdigit()]
        return max(found, default=0) + 1

    def _rotate_locked(self) -> None:
        """Roll the live file to ``<path>.<segment>``. A failed rename keeps
        appending to the live file (and retries at the next write past the
        cap); a failed reopen turns the sink off."""
        self._fh.close()
        self._fh = None
        rolled: Optional[str] = f"{self.path}.{self._segment}"
        try:
            os.replace(self.path, rolled)
        except OSError:
            rolled = None
        try:
            self._fh = open(self.path, "a")
        except OSError:
            return
        if rolled is None:
            return
        self._size = 0
        marker = {"event": "rotate", "segment": self._segment, "path": rolled}
        self._segment += 1
        self._size += self._write_line_locked(marker)
        if self.on_rotate is not None:
            self.on_rotate(marker)

    def _write_line_locked(self, rec: Dict[str, Any]) -> int:
        line = _render_event(rec)
        self._fh.write(line)
        self._fh.flush()
        return len(line)

    def write(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._size += self._write_line_locked(rec)
            if self.max_bytes and self._size >= self.max_bytes:
                self._rotate_locked()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class ConsoleHeartbeat:
    """One startup line with the platform and device kind, then a short line
    per log interval, on stderr."""

    def __init__(self, rank: int = 0, enabled: bool = True, stream: Optional[IO[str]] = None) -> None:
        self.rank = rank
        self.enabled = enabled
        self._stream = stream

    def _out(self) -> IO[str]:
        return self._stream if self._stream is not None else sys.stderr

    def startup(self, info: Dict[str, Any]) -> None:
        if self.enabled:
            print(f"[telemetry rank={self.rank}] platform={info.get('platform')} "
                  f"device_kind={info.get('device_kind')!r} devices={info.get('devices')} algo={info.get('algo')}",
                  file=self._out(), flush=True)

    def log(self, step: int, fields: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        parts = [f"step={step}"]
        for key in ("sps", "grad_steps_per_s", "mfu"):
            if fields.get(key) is not None:
                parts.append(f"{key}={fields[key]:.3g}")
        mem = fields.get("memory") or {}
        if mem.get("rss_bytes"):
            parts.append(f"rss={int(mem['rss_bytes']) >> 20}MiB")
        if mem.get("hbm_bytes_in_use"):
            parts.append(f"hbm={int(mem['hbm_bytes_in_use']) >> 20}MiB")
        print(f"[telemetry rank={self.rank}] " + " ".join(parts), file=self._out(), flush=True)
