"""Host spans with device-trace ranges (the port's own copy of
``sheeprl_tpu/telemetry/spans.py``).

A ``Span`` adds its wall-clock seconds to a thread-safe ``SpanTracker`` and
opens a ``torch.profiler.record_function`` range (seen by a running
``torch.profiler``) and an NVTX range (seen by an external CUDA profiler)
where the reference opens a ``jax.profiler.TraceAnnotation``, so the phase
also shows on the device timeline.

* Thread safety: the player thread times env interaction and the learner
  train time into the same tracker.
* Drain: ``compute(reset=True)`` snapshots and clears under one lock, so a
  log interval never counts a span of the previous one.
* Nesting: each thread keeps a stack of open spans; a nested span records
  under its own name.

``PROFILER_LOCK`` is held by whoever runs a ``torch.profiler`` session in
this process (the facade's windowed capture, the watchdog's incident dump):
Kineto's session is process-wide, and starting a second one ends the first.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

PROFILER_LOCK = threading.Lock()


class TraceRange:
    """A ``torch.profiler.record_function`` range and, where CUDA is
    available, an NVTX range of the same name."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._rf: Any = None
        self._nvtx = False

    def __enter__(self) -> "TraceRange":
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


class SpanTracker:
    """Thread-safe name -> (seconds, count) accumulator that drains."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._stack = threading.local()

    def _names(self) -> List[str]:
        names = getattr(self._stack, "names", None)
        if names is None:
            names = self._stack.names = []
        return names

    def current(self) -> Optional[str]:
        names = self._names()
        return names[-1] if names else None

    def depth(self) -> int:
        return len(self._names())

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + seconds
            self._counts[name] = self._counts.get(name, 0) + 1

    def compute(self, reset: bool = False) -> Dict[str, float]:
        """name -> accumulated seconds; ``reset`` drains under the same lock."""
        with self._lock:
            out = dict(self._totals)
            if reset:
                self._totals.clear()
                self._counts.clear()
        return out

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()

    def span(self, name: str, enabled: bool = True, annotate: bool = True) -> "Span":
        return Span(name, tracker=self, enabled=enabled, annotate=annotate)


# the process-wide tracker every Telemetry facade drains
GLOBAL_TRACKER = SpanTracker()


class Span:
    """Context manager: wall-clock seconds into the tracker, plus a trace
    range while it is open (``annotate``)."""

    def __init__(self, name: str, tracker: Optional[SpanTracker] = None, enabled: bool = True,
                 annotate: bool = True) -> None:
        self.name = name
        self.tracker = tracker if tracker is not None else GLOBAL_TRACKER
        self.enabled = enabled
        self.annotate = annotate
        self._start: Optional[float] = None
        self._range: Optional[TraceRange] = None

    def __enter__(self) -> "Span":
        if self.enabled:
            self.tracker._names().append(self.name)
            if self.annotate:
                self._range = TraceRange(self.name).__enter__()
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.enabled and self._start is not None:
            elapsed = time.perf_counter() - self._start
            if self._range is not None:
                self._range.__exit__(*exc)
                self._range = None
            self.tracker._names().pop()
            self.tracker.record(self.name, elapsed)
        self._start = None
        return False
