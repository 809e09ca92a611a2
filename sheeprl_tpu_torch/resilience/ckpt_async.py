"""Asynchronous checkpoint writing (counterpart of
``sheeprl_tpu/resilience/ckpt_async.py``).

The caller (the learner thread) pays only the host snapshot
(``CheckpointManager.to_host_payload``: an explicit copy of every tensor,
so the next burst cannot change what is written); a background thread does
the atomic tmp → fsync → rename write. In-flight writes are bounded
(``max_in_flight``): when the writer falls behind, ``save`` blocks for a
slot instead of queueing unbounded host copies.

Every save makes a ``ckpt_async`` event on the telemetry stream
(``telem.emit``, as in the JAX package): ``snapshot_ms`` (the snapshot
alone) and ``block_ms`` (the learner's whole wait) when it is enqueued,
``write_ms`` and ``bytes`` when it lands.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils.checkpoint import CheckpointManager


class AsyncCheckpointWriter:
    """Drop-in for ``CheckpointManager.save`` with background writes.
    ``sync=True`` writes inline, with the same records (``mode="sync"``)."""

    def __init__(
        self,
        manager: CheckpointManager,
        max_in_flight: int = 1,
        on_write: Optional[Callable[[int, str], None]] = None,
        sync: bool = False,
        telem: Any = None,
    ):
        self.manager = manager
        self.telem = telem
        self.on_write = on_write
        self.sync = bool(sync)
        self.last_saved_step: Optional[int] = None  # last step handed to save()
        self.last_written_step: Optional[int] = None  # last step durably on disk
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(max_in_flight)))
        self._pending = 0
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    @property
    def enabled(self) -> bool:
        return self.manager.enabled

    def list_checkpoints(self):
        return self.manager.list_checkpoints()

    def _emit(self, rec: Dict[str, Any]) -> None:
        if self.telem is not None:
            self.telem.emit(rec)

    def save(self, step: int, state: Dict[str, Any]) -> Optional[str]:
        """Snapshot ``state`` to the host and schedule the durable write.
        Returns the path the checkpoint will land at."""
        t0 = time.perf_counter()
        payload = self.manager.to_host_payload(state)
        snapshot_ms = (time.perf_counter() - t0) * 1000.0
        if not self.manager.enabled:
            return None
        step = int(step)
        if self.sync:
            path = self.manager.write_payload(step, payload)
            block_ms = (time.perf_counter() - t0) * 1000.0
            self.last_saved_step = step
            if path:
                self._finish(step, path, snapshot_ms, block_ms, block_ms - snapshot_ms, "sync")
            return path
        self._ensure_worker()
        with self._cv:
            self._pending += 1
        self._q.put((step, payload, snapshot_ms))  # blocks while max_in_flight writes are queued
        block_ms = (time.perf_counter() - t0) * 1000.0
        self.last_saved_step = step
        self._emit({"event": "ckpt_async", "action": "enqueued", "step": step, "snapshot_ms": snapshot_ms,
                    "block_ms": block_ms, "in_flight": self._pending, "mode": "async"})
        return str(self.manager.dir / f"ckpt_{step}.ckpt")

    def _finish(self, step: int, path: str, snapshot_ms: float, block_ms: float, write_ms: float, mode: str) -> None:
        self.last_written_step = step
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = 0
        if self.on_write is not None:
            try:
                self.on_write(step, path)
            except Exception as err:
                print(f"[resilience] checkpoint on_write hook failed: {err}", file=sys.stderr)
        self._emit({"event": "ckpt_async", "action": "written", "step": step, "snapshot_ms": snapshot_ms,
                    "block_ms": block_ms, "write_ms": write_ms, "bytes": nbytes, "path": path, "mode": mode})

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, name="ckpt-async-writer", daemon=True)
            self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, payload, snapshot_ms = item
            try:
                t0 = time.perf_counter()
                path = self.manager.write_payload(step, payload)
                write_ms = (time.perf_counter() - t0) * 1000.0
                if path:
                    self._finish(step, path, snapshot_ms, 0.0, write_ms, "async")
            except Exception as err:  # a failed write must not kill training
                print(f"[resilience] async checkpoint write failed: {err}", file=sys.stderr)
                self._emit({"event": "ckpt_async", "action": "failed", "step": int(step), "mode": "async"})
            finally:
                del payload
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued write has landed (True) or ``timeout``
        elapsed (False)."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout=timeout)

    def close(self, timeout: Optional[float] = None) -> bool:
        """Flush pending writes and stop the worker."""
        if self._closed:
            return True
        self._closed = True
        drained = self.flush(timeout=timeout)
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._worker.join(timeout=5.0)
        return drained
