"""Run supervision (counterpart of ``sheeprl_tpu/resilience/supervisor.py``):
retries with jittered backoff, a stalled-progress watchdog, and supervised
restarts.

``with_retries`` wraps a transient operation (env construction) in jittered
exponential backoff; only the retryable exception types are retried, so a
configuration error surfaces at once. ``make_retrying`` builds it from
``resilience.retries`` for ``utils/env.py:vectorize``.

``HeartbeatWatchdog`` watches step progress: ``RunGuard.stop_reached`` beats
it with the policy step. When the step has not advanced for ``stall_s``
seconds it fires once per stall: a ``watchdog`` event (``action: stall``)
with a short ``torch.profiler`` capture (CPU of every thread, and CUDA where
there is a card) written as a Chrome trace under
``<trace_dir>/incident_NNN_<t>/trace.json``; with ``action="preempt"`` it
raises the cooperative preemption flag (``PreemptionGuard.trigger``), so a
wedged loop checkpoints and exits through the SIGTERM drain (a second event,
``action: preempt``). The capture is best effort: where another
``torch.profiler`` session is active (a second Kineto session would end the
first), or the capture fails, the dump returns None and the event carries
``trace_error`` instead of ``trace_dir``. It never moves the run's device.

``supervise`` re-invokes a training entry point after a crash with
``checkpoint.resume_from`` set to the newest checkpoint the crashed attempt
left (``latest_checkpoint_under``).
"""
from __future__ import annotations

import os
import random
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional, Tuple, Type

import torch
from torch.profiler import ProfilerActivity, profile

from ..telemetry.spans import PROFILER_LOCK
from .preemption import PreemptionGuard


def _emit(telem: Any, rec: dict) -> None:
    if telem is not None:
        try:
            telem.emit(rec)
        except Exception:  # noqa: BLE001 - telemetry never fails the supervised operation
            pass


def _backoff(attempt: int, backoff_s: float, max_backoff_s: float, jitter: float) -> float:
    sleep_s = min(float(max_backoff_s), float(backoff_s) * (2 ** (attempt - 1)))
    return max(0.0, sleep_s * (1.0 + random.uniform(-jitter, jitter)))


def with_retries(
    fn: Callable[[], Any],
    op: str = "op",
    attempts: int = 3,
    backoff_s: float = 1.0,
    max_backoff_s: float = 30.0,
    jitter: float = 0.5,
    retry_on: Tuple[Type[BaseException], ...] = (OSError, ConnectionError, TimeoutError),
    telem: Any = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """``fn()`` with up to ``attempts`` tries and jittered exponential backoff
    between them. Only exceptions of ``retry_on`` are retried; a
    ``ValueError`` and the like surfaces at once."""
    attempts = max(1, int(attempts))
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as err:
            if attempt >= attempts:
                raise
            sleep_s = _backoff(attempt, backoff_s, max_backoff_s, jitter)
            print(f"[resilience] {op} failed (attempt {attempt}/{attempts}): {err!r}; retrying in {sleep_s:.2f}s",
                  file=sys.stderr, flush=True)
            _emit(telem, {"event": "retry", "op": str(op), "attempt": attempt, "error": repr(err),
                          "sleep_s": round(sleep_s, 3)})
            if on_retry is not None:
                on_retry(attempt, err)
            time.sleep(sleep_s)


def make_retrying(cfg: Any, telem: Any = None) -> Optional[Callable[..., Any]]:
    """A ``with_retries`` runner from ``resilience.retries`` (None when it is
    disabled or allows one attempt only)."""
    sel = cfg.select
    if not bool(sel("resilience.retries.enabled", True)):
        return None
    attempts = int(sel("resilience.retries.attempts", 3) or 1)
    if attempts <= 1:
        return None

    def run(fn: Callable[[], Any], op: str = "op") -> Any:
        return with_retries(fn, op=op, attempts=attempts, backoff_s=float(sel("resilience.retries.backoff_s", 1.0)),
                            max_backoff_s=float(sel("resilience.retries.max_backoff_s", 30.0)),
                            jitter=float(sel("resilience.retries.jitter", 0.5)), telem=telem)

    return run


def dump_profiler_trace(out_dir: str, seconds: float) -> Tuple[Optional[str], Optional[str]]:
    """Capture ``seconds`` of ``torch.profiler`` (CPU ops of every thread,
    CUDA kernels where there is a card) into ``<out_dir>/trace.json``.
    Returns ``(out_dir, None)``, or ``(None, reason)`` where it could not."""
    if not PROFILER_LOCK.acquire(blocking=False):
        return None, "another torch.profiler capture of this process is active"
    try:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        kwargs = {}
        try:  # the loop's thread, not this one, is the one to see
            from torch._C._profiler import _ExperimentalConfig

            kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        prof = profile(activities=acts, **kwargs)
        prof.start()
        try:
            time.sleep(max(0.1, float(seconds)))
        finally:
            prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        return out_dir, None
    except Exception as err:  # noqa: BLE001 - best effort: the watchdog reports it and goes on
        return None, f"{type(err).__name__}: {err}"
    finally:
        PROFILER_LOCK.release()


class HeartbeatWatchdog:
    """A background thread that detects stalled step progress: ``beat(step)``
    stamps the clock when the step advances; the monitor fires once per
    stall after ``stall_s`` seconds without an advance."""

    def __init__(
        self,
        stall_s: float = 300.0,
        action: str = "none",
        telem: Any = None,
        trace_dir: Optional[str] = None,
        trace_s: float = 3.0,
        poll_s: float = 1.0,
        on_stall: Optional[Callable[[int, float], None]] = None,
    ):
        self.stall_s = float(stall_s)
        self.action = str(action)
        self.telem = telem
        self.trace_dir = trace_dir
        self.trace_s = float(trace_s)
        self.poll_s = float(poll_s)
        self.on_stall = on_stall
        self._last_step: Optional[int] = None
        self._last_t = time.monotonic()
        self._fired = False
        self._outer_profiler = False  # a torch.profiler session was active on the beating thread
        self._incidents = 0  # the run's stall counter (names the trace dirs)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="resilience-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0 + self.trace_s)
            self._thread = None

    def beat(self, step: int) -> None:
        # the profiler's state is per thread: read it on the loop's thread
        self._outer_profiler = bool(torch._C._autograd._profiler_enabled())
        step = int(step)
        if step != self._last_step:
            self._last_step = step
            self._last_t = time.monotonic()
            self._fired = False

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            stalled_s = time.monotonic() - self._last_t
            if stalled_s < self.stall_s or self._fired:
                continue
            self._fired = True
            self._incidents += 1
            step = self._last_step or 0
            print(f"[resilience] watchdog: no step advance for {stalled_s:.0f}s (last step {step}, incident "
                  f"{self._incidents}); action={self.action}", file=sys.stderr, flush=True)
            rec = {"event": "watchdog", "action": "stall", "step": step, "stalled_s": round(stalled_s, 1),
                   "incident": self._incidents}
            trace_dir, err = self._dump_trace()
            if trace_dir:
                rec["trace_dir"] = trace_dir
            elif err:
                rec["trace_error"] = err
            _emit(self.telem, rec)
            if self.on_stall is not None:
                try:
                    self.on_stall(step, stalled_s)
                except Exception:  # noqa: BLE001 - a callback never stops the monitor
                    pass
            if self.action == "preempt":
                # the cooperative drain: the loop (or a wait parked on a dead
                # thread's queue) checkpoints and exits as on SIGTERM
                PreemptionGuard.trigger("watchdog")
                _emit(self.telem, {"event": "watchdog", "action": "preempt", "step": step})

    def _dump_trace(self) -> Tuple[Optional[str], Optional[str]]:
        """A short capture into a directory of this incident's own (the
        incident counter in its name: repeated stalls never overwrite an
        earlier trace)."""
        if not self.trace_dir:
            return None, None
        if self._outer_profiler:
            return None, "a torch.profiler session is active on the training thread"
        out = os.path.join(self.trace_dir, f"incident_{self._incidents:03d}_{int(time.time())}")
        return dump_profiler_trace(out, self.trace_s)


def latest_checkpoint_under(base: Path) -> Optional[Path]:
    """The newest complete checkpoint across every ``version_*/`` under a
    run's base dir (newest version first, highest step within it)."""
    from ..utils.checkpoint import CheckpointManager

    base = Path(base)
    if not base.is_dir():
        return None
    best: Optional[Tuple[int, int, Path]] = None
    for version_dir in base.glob("version_*"):
        try:
            version = int(version_dir.name.split("_")[1])
        except (IndexError, ValueError):
            continue
        ckpts = CheckpointManager(str(version_dir), enabled=False).list_checkpoints()
        if not ckpts:
            continue
        step = int(ckpts[-1].stem.split("_")[1])
        if best is None or (version, step) > best[:2]:
            best = (version, step, ckpts[-1])
    return best[2] if best else None


def supervise(
    run_fn: Callable[[Any], None],
    cfg: Any,
    attempts: int = 2,
    backoff_s: float = 5.0,
    max_backoff_s: float = 120.0,
    jitter: float = 0.5,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
) -> None:
    """Run a training entry point with restart-with-backoff: after a crash,
    the newest checkpoint under ``logs/runs/<root_dir>/<run_name>`` becomes
    ``checkpoint.resume_from`` of the next attempt, so a restart continues
    the run. ``KeyboardInterrupt`` and ``SystemExit`` always propagate."""
    attempts = max(1, int(attempts))
    base = Path(os.getcwd()) / "logs" / "runs" / str(cfg.select("root_dir")) / str(cfg.select("run_name"))
    for attempt in range(1, attempts + 1):
        try:
            run_fn(cfg)
            return
        except (KeyboardInterrupt, SystemExit):
            raise
        except retry_on as err:
            if attempt >= attempts:
                raise
            ckpt = latest_checkpoint_under(base)
            sleep_s = _backoff(attempt, backoff_s, max_backoff_s, jitter)
            print(f"[resilience] run attempt {attempt}/{attempts} crashed: {err!r}; restarting in {sleep_s:.1f}s"
                  + (f" from {ckpt}" if ckpt else " from scratch"), file=sys.stderr, flush=True)
            if ckpt is not None:
                cfg.set_path("checkpoint.resume_from", str(ckpt))
            time.sleep(sleep_s)
