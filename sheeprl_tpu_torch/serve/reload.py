"""Checkpoint hot-reload: watch a run's checkpoint dir, swap params live (the
port's counterpart of ``sheeprl_tpu/serve/reload.py``).

A background thread polls the directory for a ``ckpt_<step>.ckpt`` with a
step newer than the one being served (writes are atomic ``os.replace``, so a
file that exists is complete). New checkpoints are loaded through the
inference-only path (optimizer state and replay buffers are dropped before
anything touches the serving device) and handed to
``InferencePolicy.swap_params`` — a new dict of device tensors behind one
reference swap, which in-flight batches never observe mid-step. Each attempt emits a ``reload``
event on the serve telemetry stream; a corrupt or half-written file is
reported and skipped, never fatal.
"""
from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from .policy import InferencePolicy


def _list_checkpoints(ckpt_dir: Path) -> List[Tuple[int, Path]]:
    if not ckpt_dir.is_dir():
        return []
    out: List[Tuple[int, Path]] = []
    for p in ckpt_dir.iterdir():
        if p.suffix != ".ckpt":
            continue
        try:
            out.append((int(p.stem.split("_")[1]), p))
        except (IndexError, ValueError):
            continue
    return sorted(out)


class CheckpointReloader:
    """Polls ``ckpt_dir`` and hot-swaps the policy's params."""

    def __init__(
        self,
        policy: InferencePolicy,
        ckpt_dir: Any,
        poll_interval_s: float = 2.0,
        loaded_step: int = -1,
        sink: Any = None,
    ) -> None:
        self.policy = policy
        self.ckpt_dir = Path(ckpt_dir)
        self.poll_interval_s = float(poll_interval_s)
        self.loaded_step = int(loaded_step)
        self._sink = sink
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # poll_once is reachable from two threads — the background _loop and
        # any HTTP admin request (`POST /admin/reload`, server.py): without
        # the lock, two concurrent polls both pass the `step <= loaded_step`
        # check and double-swap the same checkpoint
        self._poll_lock = threading.Lock()

    def _emit(self, rec: Dict[str, Any]) -> None:
        if self._sink is None:
            return
        try:
            self._sink.write(rec)
        except Exception:
            pass

    def poll_once(self) -> bool:
        """Check for a newer checkpoint; swap if found. Returns True on swap.
        Serialized: the poll thread and admin-reload requests may overlap."""
        with self._poll_lock:
            return self._poll_once_locked()

    def _poll_once_locked(self) -> bool:
        ckpts = _list_checkpoints(self.ckpt_dir)
        if not ckpts:
            return False
        step, path = ckpts[-1]
        if step <= self.loaded_step:
            return False
        from ..utils.checkpoint import CheckpointManager

        try:
            state = CheckpointManager.load_for_inference(path)
            version = self.policy.swap_params(state)
        except Exception as e:
            self._emit(
                {"event": "reload", "action": "failed", "path": str(path), "step": step, "error": str(e)}
            )
            # don't retry this step forever: a truncated file won't heal
            self.loaded_step = step
            return False
        self.loaded_step = step
        self._emit(
            {
                "event": "reload",
                "action": "swapped",
                "path": str(path),
                "step": step,
                "params_version": version,
            }
        )
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                pass
            self._stop.wait(self.poll_interval_s)

    def start(self) -> "CheckpointReloader":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True, name="ckpt-reloader")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
