"""Cooperative preemption handling (the port's own copy of
``sheeprl_tpu/resilience/preemption.py``).

A preemptible machine gets a SIGTERM with a short grace window before it
disappears. `PreemptionGuard` converts that asynchronous signal into
a *cooperative* stop: the handler only sets a process-wide flag + deadline,
and the train loop observes it at the next step boundary
(`RunGuard.stop_reached`), writes a final checkpoint, and exits cleanly.

Cloud providers also announce maintenance ahead of the signal. The guard accepts a pluggable
*poller* — any callable returning truthy when preemption is imminent —
polled at step boundaries with a configurable cadence, so a run can start
draining before the SIGTERM even lands.

Signal handlers can only be installed from the main thread, which is the
learner's (the overlap engine's player is a worker thread); elsewhere the
guard degrades to poller-only.
"""
from __future__ import annotations

import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

# Process-wide state: a SIGTERM is addressed to the process, not to one
# guard instance, and a second guard (p2e exploration → finetuning in one
# process) must see a flag raised while the first was installed.
_EVENT = threading.Event()
_INFO: Dict[str, Any] = {"signal": None, "at": None}
_LOCK = threading.Lock()


def _record(sig_name: str) -> None:
    with _LOCK:
        if not _EVENT.is_set():
            _INFO["signal"] = sig_name
            _INFO["at"] = time.monotonic()
            _EVENT.set()


def preemption_requested() -> bool:
    """Process-wide flag: has any signal/poller requested preemption?"""
    return _EVENT.is_set()


def clear_preemption() -> None:
    """Reset the process-wide flag (new run in the same process, tests)."""
    with _LOCK:
        _EVENT.clear()
        _INFO["signal"] = None
        _INFO["at"] = None


class CountdownPoller:
    """Deterministic maintenance-event poller for tests and smoke scripts:
    reports preemption after being polled `n` times — the in-process
    equivalent of a SIGTERM landing at a known step boundary."""

    def __init__(self, n: int = 1):
        self.n = int(n)
        self.calls = 0

    def __call__(self) -> bool:
        self.calls += 1
        return self.calls >= self.n


class PreemptionGuard:
    """Signal catcher + maintenance poller with a grace deadline.

    Parameters
    ----------
    signals: names of signals to trap (default SIGTERM, SIGINT).
    grace_s: budget between the request and process exit — the final
        checkpoint must land inside it (`deadline_remaining`).
    poller: optional callable -> bool, polled at most every `poll_every_s`
        from `poll()` (called at step boundaries by `RunGuard`).
    """

    def __init__(
        self,
        signals: Iterable[str] = ("SIGTERM", "SIGINT"),
        grace_s: float = 30.0,
        poller: Optional[Callable[[], bool]] = None,
        poll_every_s: float = 5.0,
    ):
        self.grace_s = float(grace_s)
        self.poller = poller
        self.poll_every_s = float(poll_every_s)
        self._signal_names = tuple(signals)
        self._old_handlers: Dict[int, Any] = {}
        self._installed = False
        self._last_poll = 0.0

    # -- installation ------------------------------------------------------
    def install(self) -> "PreemptionGuard":
        for name in self._signal_names:
            signum = getattr(signal, name, None)
            if signum is None:
                continue
            try:
                self._old_handlers[signum] = signal.signal(signum, self._handler)
            except ValueError:
                # not the main thread: poller-only operation
                break
        self._installed = bool(self._old_handlers)
        return self

    def uninstall(self) -> None:
        for signum, old in self._old_handlers.items():
            try:
                signal.signal(signum, old if old is not None else signal.SIG_DFL)
            except ValueError:
                pass
        self._old_handlers.clear()
        self._installed = False

    def _handler(self, signum: int, frame: Any) -> None:
        if _EVENT.is_set() and signum == getattr(signal, "SIGINT", None):
            # second ctrl-C: the user means it — don't swallow the abort
            raise KeyboardInterrupt
        _record(signal.Signals(signum).name)
        print(
            f"[resilience] {signal.Signals(signum).name} received: draining at the "
            f"next step boundary (grace {self.grace_s:.0f}s)",
            file=sys.stderr,
            flush=True,
        )

    # -- triggering --------------------------------------------------------
    @staticmethod
    def trigger(reason: str = "manual") -> None:
        """Programmatic preemption (watchdog escalation, tests)."""
        _record(reason)

    def poll(self) -> bool:
        """Step-boundary check: consult the maintenance poller (rate-limited)
        and return the process-wide flag."""
        if self.poller is not None and not _EVENT.is_set():
            now = time.monotonic()
            if now - self._last_poll >= self.poll_every_s:
                self._last_poll = now
                try:
                    if self.poller():
                        _record("maintenance_poller")
                except Exception as err:  # a flaky poller must not kill training
                    print(f"[resilience] maintenance poller failed: {err}", file=sys.stderr)
        return _EVENT.is_set()

    # -- state -------------------------------------------------------------
    @property
    def requested(self) -> bool:
        return _EVENT.is_set()

    @property
    def signal_name(self) -> Optional[str]:
        return _INFO["signal"]

    def deadline_remaining(self) -> float:
        """Seconds left in the grace window (inf when not preempted)."""
        at = _INFO["at"]
        if at is None:
            return float("inf")
        return max(0.0, self.grace_s - (time.monotonic() - at))
