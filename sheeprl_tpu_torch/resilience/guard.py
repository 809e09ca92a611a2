"""``RunGuard``: the resilience object the training loop wires in
(counterpart of ``sheeprl_tpu/resilience/guard.py``).

It owns, behind ``setup`` / ``stop_reached`` / ``close``:

* the wall-clock stopper (``algo.max_wall_time_s``),
* the ``PreemptionGuard`` (SIGTERM/SIGINT and the maintenance poller) with
  the final-checkpoint-within-grace drain,
* the optional ``HeartbeatWatchdog`` (``resilience.watchdog``), beaten at
  every ``stop_reached`` and stopped in ``close``; its incident traces go
  under ``<log_dir>/watchdog_trace/``,
* the ``AsyncCheckpointWriter`` over the loop's ``CheckpointManager``
  (``guard.ckpt``, a drop-in for the manager), and
* the resume manifest refresh after every successful write,

and writes the ``resume``, ``preempt`` and ``watchdog`` events to the
telemetry stream (``telem.emit``) where the JAX package's does.

The overlapped loop integrates through two surfaces: the player thread
polls ``guard.preempted`` from the engine's waits, so it stops feeding as
soon as the signal lands; the learner breaks at its own ``stop_reached``
boundary with ``save=False``, drains the queue into the buffer with
``engine.shutdown`` and lets ``close()`` write the final checkpoint.
"""
from __future__ import annotations

import queue
import sys
from typing import Any, Callable, Dict, Optional

from ..utils.utils import WallClockStopper, wall_cap_reached
from .ckpt_async import AsyncCheckpointWriter
from .preemption import PreemptionGuard, clear_preemption
from .supervisor import HeartbeatWatchdog


class RunGuard:
    """Preemption, wall cap and asynchronous checkpoints behind one object."""

    def __init__(
        self,
        cfg: Any,
        ckpt: AsyncCheckpointWriter,
        wall: WallClockStopper,
        preempt: Optional[PreemptionGuard] = None,
        telem: Any = None,
        watchdog: Optional[HeartbeatWatchdog] = None,
    ):
        self.cfg = cfg
        self.ckpt = ckpt
        self.wall = wall
        self.preempt = preempt
        self.telem = telem
        self.watchdog = watchdog
        self._preempt_logged = False
        self._closed = False

    def _emit(self, rec: Dict[str, Any]) -> None:
        if self.telem is not None:
            self.telem.emit(rec)

    @classmethod
    def setup(cls, cfg: Any, ckpt_manager: Any, log_dir: Optional[str] = None, telem: Any = None) -> "RunGuard":
        sel = cfg.select
        on_write = None
        if log_dir:
            from .resume import write_manifest

            on_write = lambda step, path: write_manifest(log_dir, cfg, step, path)  # noqa: E731
        writer = AsyncCheckpointWriter(
            ckpt_manager,
            max_in_flight=int(sel("resilience.async_checkpoint.max_in_flight", 1) or 1),
            on_write=on_write,
            sync=not bool(sel("resilience.async_checkpoint.enabled", True)),
            telem=telem,
        )
        preempt: Optional[PreemptionGuard] = None
        if bool(sel("resilience.preemption.enabled", True)):
            # a pending process-wide flag is deliberately NOT cleared here: a
            # SIGTERM that landed between two in-process runs drains the next
            # one too; the guard that observes a preemption clears it in close()
            poller = None
            poller_cfg = sel("resilience.preemption.poller")
            if poller_cfg:
                from ..config import instantiate

                poller = instantiate(poller_cfg)
            preempt = PreemptionGuard(
                signals=tuple(sel("resilience.preemption.signals", ("SIGTERM", "SIGINT"))),
                grace_s=float(sel("resilience.preemption.grace_s", 30.0)),
                poller=poller,
                poll_every_s=float(sel("resilience.preemption.poll_every_s", 5.0)),
            ).install()
        watchdog: Optional[HeartbeatWatchdog] = None
        if bool(sel("resilience.watchdog.enabled", False)):
            watchdog = HeartbeatWatchdog(
                stall_s=float(sel("resilience.watchdog.stall_s", 300.0)),
                action=str(sel("resilience.watchdog.action", "none")),
                telem=telem,
                trace_dir=f"{log_dir}/watchdog_trace" if log_dir else None,
                trace_s=float(sel("resilience.watchdog.trace_s", 3.0)),
            ).start()
        guard = cls(cfg, writer, WallClockStopper(cfg), preempt, telem, watchdog)
        if sel("checkpoint.resume_from"):
            guard._emit({"event": "resume", "step": 0, "checkpoint": str(sel("checkpoint.resume_from"))})
        return guard

    @property
    def preempted(self) -> bool:
        return self.preempt is not None and self.preempt.requested

    def stop_reached(
        self,
        policy_step: int,
        total_steps: int,
        state_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        save: bool = True,
    ) -> bool:
        """Call once per loop iteration. True when the loop must break
        (preemption requested or the wall budget spent), after writing the
        final checkpoint when ``save``. Beats the watchdog."""
        if self.watchdog is not None:
            self.watchdog.beat(policy_step)
        if self.preempt is not None and self.preempt.poll():
            if not self._preempt_logged:
                self._preempt_logged = True
                self._emit({"event": "preempt", "step": int(policy_step), "action": "requested",
                            "signal": str(self.preempt.signal_name), "grace_s": self.preempt.grace_s})
            if save and state_fn is not None:
                self._final_save(policy_step, state_fn)
            return True
        return wall_cap_reached(self.wall, policy_step, total_steps, self.ckpt, state_fn, self.cfg, save=save)

    def _final_save(self, policy_step: int, state_fn: Callable[[], Dict[str, Any]]) -> None:
        """The preemption drain: one last checkpoint, flushed to disk inside
        the remaining grace budget."""
        deadline = self.preempt.deadline_remaining() if self.preempt else float("inf")
        if self.ckpt.last_saved_step == int(policy_step):
            # a cadence save already targeted this step: trust it once it landed
            self.ckpt.flush(timeout=None if deadline == float("inf") else max(1.0, deadline))
            if self.ckpt.last_written_step == int(policy_step) or not self.ckpt.enabled:
                return
        try:
            self.ckpt.save(policy_step, state_fn())
        except Exception as err:
            print(f"[resilience] final preemption checkpoint failed: {err}", file=sys.stderr)
            return
        deadline = self.preempt.deadline_remaining() if self.preempt else float("inf")
        landed = self.ckpt.flush(timeout=None if deadline == float("inf") else max(1.0, deadline))
        self._emit({"event": "preempt", "step": int(policy_step),
                    "action": "checkpointed" if landed else "flush_timeout"})

    def wait(self, q: "queue.Queue", poll_s: float = 0.5) -> Any:
        """``q.get()`` that wakes up on preemption: returns the item, or None
        when preemption was requested first."""
        while True:
            try:
                return q.get(timeout=poll_s)
            except queue.Empty:
                if self.preempted:
                    return None

    def close(self, policy_step: int = 0, state_fn: Optional[Callable[[], Dict[str, Any]]] = None) -> None:
        """Call after the loop: writes the final preemption checkpoint if the
        loop broke out without one, flushes the async writer, stops the
        watchdog and uninstalls the signal handlers."""
        if self._closed:
            return
        self._closed = True
        try:
            if self.preempted and state_fn is not None:
                self._final_save(policy_step, state_fn)
        finally:
            deadline = self.preempt.deadline_remaining() if self.preempted and self.preempt else float("inf")
            self.ckpt.close(timeout=None if deadline == float("inf") else max(1.0, deadline))
            if self.watchdog is not None:
                self.watchdog.stop()
            if self.preempt is not None:
                if self.preempt.requested:
                    # this run drained the request: consume the process-wide
                    # flag so the next in-process run starts clean
                    clear_preemption()
                self.preempt.uninstall()
