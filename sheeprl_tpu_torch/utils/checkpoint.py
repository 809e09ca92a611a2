"""Checkpoint write, prune and restore (counterpart of
``sheeprl_tpu/utils/checkpoint.py``).

A checkpoint is ``<log_dir>/checkpoint/ckpt_<policy_step>.ckpt``: a
``torch.save`` of a dict of tensors, state dicts, numpy arrays and counters,
written atomically (tmp file, fsync, rename, fsync of the directory) with
``keep_last`` pruning in numeric step order.

The snapshot (``to_host_payload``) copies every tensor to the host
explicitly: ``state_dict()`` and ``optimizer.state_dict()`` hold references
to tensors that the next burst updates in place, and on the CPU
``Tensor.cpu()`` returns the tensor itself. Card tensors are copied into
pinned host memory without blocking and the learner's stream is
synchronised once at the end (a stream sync, not a device-wide one).
"""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _snapshot(tree: Any, streams: set) -> Any:
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            streams.add(t.device)
            return out
        return t.clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return {k: _snapshot(v, streams) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v, streams) for v in tree)
    return tree


def snapshot(tree: Any) -> Any:
    """A host copy of ``tree`` that shares no storage with it, complete on
    return."""
    streams: set = set()
    out = _snapshot(tree, streams)
    for dev in streams:
        torch.cuda.current_stream(dev).synchronize()
    return out


def save_atomic(path: os.PathLike, payload: Any) -> None:
    """``torch.save`` a host payload to ``path`` durably and atomically: a
    tmp file, fsync, rename, fsync of the directory. After a crash either
    the old file or the new one exists, never a torn one."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    try:
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)
    try:
        fd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # directories are not fsync-able on some filesystems


class CheckpointManager:
    """Writes ``ckpt_{policy_step}.ckpt`` under ``<log_dir>/checkpoint``."""

    def __init__(self, log_dir: str, keep_last: Optional[int] = None, enabled: bool = True):
        self.dir = Path(log_dir) / "checkpoint"
        self.keep_last = keep_last
        self.enabled = enabled
        if enabled:
            self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, state: Dict[str, Any]) -> Optional[str]:
        return self.write_payload(step, self.to_host_payload(state))

    def to_host_payload(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The host snapshot of ``state``, taken on the calling thread (the
        one that owns the train step)."""
        return snapshot(state)

    def write_payload(self, step: int, payload: Dict[str, Any]) -> Optional[str]:
        """Durable atomic write of a host payload: after a crash either the
        old or the new checkpoint exists, never a torn file."""
        if not self.enabled:
            return None
        path = self.dir / f"ckpt_{step}.ckpt"
        save_atomic(path, payload)
        self._prune()
        return str(path)

    def _prune(self) -> None:
        if not self.keep_last:
            return
        # never delete the newest checkpoint, whatever keep_last says
        for old in self.list_checkpoints()[: -max(int(self.keep_last), 1)]:
            try:
                os.unlink(old)
            except OSError:
                pass

    def list_checkpoints(self) -> List[Path]:
        if not self.dir.is_dir():
            return []
        out = []
        for p in self.dir.iterdir():
            stem = p.stem.split("_")
            if p.suffix == ".ckpt" and len(stem) == 2 and stem[0] == "ckpt" and stem[1].isdigit():
                out.append(p)
        return sorted(out, key=lambda p: int(p.stem.split("_")[1]))

    @staticmethod
    def load(path: os.PathLike, map_location: Any = "cpu") -> Dict[str, Any]:
        """The whole state, tensors on ``map_location`` (a checkpoint written
        on the card loads on the CPU and the other way round)."""
        return torch.load(path, map_location=map_location, weights_only=False)

    # top-level keys only training needs: optimizer moments and the replay
    # buffer dominate the size and are dead weight for evaluation
    TRAIN_ONLY_KEYS = ("rb", "opt_state", "opt_states")

    @classmethod
    def load_for_inference(cls, path: os.PathLike, map_location: Any = "cpu") -> Dict[str, Any]:
        """Load for evaluation: optimizer states and the replay buffer are
        dropped."""
        payload = cls.load(path, map_location)
        if isinstance(payload, dict):
            payload = {k: v for k, v in payload.items() if k not in cls.TRAIN_ONLY_KEYS}
        return payload


def gen_state(gen: torch.Generator) -> Dict[str, Any]:
    """A generator's state as a checkpoint holds it: its device type and bytes."""
    return {"device": gen.device.type, "state": gen.get_state()}


def set_gen_state(gen: torch.Generator, saved: Dict[str, Any], name: str, tag: str = "checkpoint") -> None:
    """Restore a generator's state. The state of a CUDA generator (Philox
    seed and offset) does not fit a CPU one (Mersenne twister) or the other
    way round: across device types the generator is seeded from the saved
    state's bytes instead, and the run says so on stderr, under ``[tag]``."""
    state = saved["state"].cpu()
    if saved["device"] == gen.device.type:
        gen.set_state(state)
        return
    seed = int(np.random.SeedSequence(state.numpy().tolist()).generate_state(1, np.uint32)[0])
    gen.manual_seed(seed)
    print(f"[{tag}] the {name} generator was saved on {saved['device']} and runs on {gen.device.type}: "
          f"seeded from the saved state ({seed})", file=sys.stderr, flush=True)


def param_sums(modules: Dict[str, Any]) -> Dict[str, float]:
    """Float64 sum of every parameter and buffer of each module (a state
    dict or a module): the fingerprint a resumed run prints, to be held
    against the checkpoint file's."""
    out = {}
    for name, m in modules.items():
        sd = m.state_dict() if hasattr(m, "state_dict") else m
        out[name] = float(sum(float(t.double().sum()) for t in sd.values()))
    return out
