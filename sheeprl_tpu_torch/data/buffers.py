"""Host-side replay buffers in plain numpy (the port's own copy of
``ReplayBuffer``, ``SequentialReplayBuffer`` and ``EnvIndependentReplayBuffer``
from ``sheeprl_tpu/data/buffers.py``, without memmap storage and the native
gather, which are not ported yet).

``ReplayBuffer`` stores [buffer_size, n_envs, ...] per key; samples come back
[n_samples, batch, ...]; ``SequentialReplayBuffer.sample`` returns
[n_samples, seq_len, batch, ...].

``state_dict``/``load_state_dict`` carry the stored rows, the write head and
the sampling generator's state; ``checkpoint_state_dict`` is the state a
resumable checkpoint holds (the row at the write head marked truncated).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class ReplayBuffer:
    """Circular dict buffer of shape [buffer_size, n_envs, ...] per key."""

    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        seed: Optional[Any] = None,
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"buffer_size must be > 0, got {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"n_envs must be > 0, got {n_envs}")
        # an owned generator (int seed or np.random.SeedSequence), not np.random
        self._rng = np.random.default_rng(seed)
        self._buffer_size = int(buffer_size)
        self._n_envs = int(n_envs)
        self._obs_keys = tuple(obs_keys)
        self._buf: Dict[str, np.ndarray] = {}
        self._pos = 0
        self._full = False

    def add(self, data: Dict[str, np.ndarray], validate_args: bool = False) -> None:
        """Append [T, n_envs, ...] per key, wrapping around circularly."""
        if validate_args:
            if not isinstance(data, dict):
                raise ValueError(f"'data' must be a dict, got {type(data)}")
            lengths = {k: v.shape[0] for k, v in data.items()}
            if len(set(lengths.values())) > 1:
                raise RuntimeError(f"Inconsistent time dimension across keys: {lengths}")
            for k, v in data.items():
                if v.ndim < 2 or v.shape[1] != self._n_envs:
                    raise RuntimeError(f"'{k}' must be [T, n_envs={self._n_envs}, ...], got {v.shape}")
        t = next(iter(data.values())).shape[0]
        if t == 0:
            return
        for k, v in data.items():
            if k not in self._buf:
                self._buf[k] = np.zeros((self._buffer_size, self._n_envs) + v.shape[2:], dtype=v.dtype)
        idxs = (self._pos + np.arange(t)) % self._buffer_size
        for k, v in data.items():
            if t >= self._buffer_size:
                self._buf[k][idxs[-self._buffer_size :]] = v[-self._buffer_size :]
            else:
                self._buf[k][idxs] = v
        if self._pos + t >= self._buffer_size:
            self._full = True
        self._pos = int((self._pos + t) % self._buffer_size)

    def state_dict(self) -> Dict[str, Any]:
        """The stored rows only (``[:pos]`` until the buffer is full: the
        storage is allocated whole, and a large buffer early in a run is
        mostly untouched zeros), the write head and the sampling state."""
        n = self._buffer_size if self._full else self._pos
        return {
            "buffer": {k: np.asarray(v[:n]).copy() for k, v in self._buf.items()},
            "size": self._buffer_size,
            "pos": self._pos,
            "full": self._full,
            "rng": self._rng.bit_generator.state,
        }

    def checkpoint_state_dict(self) -> Dict[str, Any]:
        """State for a resumable checkpoint. The envs are not saved, so the
        row at the current write position is marked truncated: a resumed
        sequential sample can never join the pre-save tail and the
        post-resume head into one trajectory. The live buffer keeps its
        flags (the surgery is on the copy)."""
        state = self.state_dict()
        if "truncated" in state["buffer"] and (self._full or self._pos > 0):
            state["buffer"]["truncated"][(state["pos"] - 1) % self._buffer_size, :] = 1
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> "ReplayBuffer":
        if int(state["size"]) != self._buffer_size:
            raise ValueError(
                f"the checkpoint's buffer holds {state['size']} rows, this one {self._buffer_size}: resume with "
                "the same buffer.size"
            )
        self._buf = {}
        for k, v in state["buffer"].items():
            if v.shape[1] != self._n_envs:
                raise ValueError(f"the checkpoint's '{k}' has {v.shape[1]} envs, this buffer {self._n_envs}")
            self._buf[k] = np.zeros((self._buffer_size,) + v.shape[1:], dtype=v.dtype)
            self._buf[k][: len(v)] = v
        self._pos = int(state["pos"])
        self._full = bool(state["full"])
        if state.get("rng") is not None:
            self._rng.bit_generator.state = state["rng"]
        return self


class SequentialReplayBuffer(ReplayBuffer):
    """Samples contiguous length-``sequence_length`` windows ignoring episode
    bounds. Returns [n_samples, seq_len, batch_size, ...]."""

    batch_axis: int = 2

    def sample_starts(self, total: int, sequence_length: int) -> np.ndarray:
        L = sequence_length
        if not self._full and self._pos - L + 1 < 1:
            raise ValueError(f"Cannot sample a sequence of length {L}: only {self._pos} steps stored")
        if self._full:
            # any start whose window [s, s+L) does not cross the write head
            offsets = self._rng.integers(0, self._buffer_size - L + 1, size=total)
            return (self._pos + offsets) % self._buffer_size
        return self._rng.integers(0, self._pos - L + 1, size=total)

    def sample(
        self, batch_size: int, n_samples: int = 1, sequence_length: int = 1, **kwargs: Any
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be > 0")
        if not self._full and self._pos == 0:
            raise ValueError("No data in the buffer, cannot sample")
        L = sequence_length
        total = batch_size * n_samples
        starts = self.sample_starts(total, L)
        env_idxs = self._rng.integers(0, self._n_envs, size=total)
        seq = (starts[:, None] + np.arange(L)[None, :]) % self._buffer_size  # [total, L]
        out: Dict[str, np.ndarray] = {}
        for k, arr in self._buf.items():
            taken = arr[seq, env_idxs[:, None]].reshape(n_samples, batch_size, L, *arr.shape[2:])
            out[k] = np.ascontiguousarray(np.swapaxes(taken, 1, 2))
        return out


class EnvIndependentReplayBuffer:
    """One sub-buffer per env: per-env ``add(indices)`` (Dreamer's per-env
    reset rows) and multinomial cross-env sampling."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        buffer_cls: type = SequentialReplayBuffer,
        seed: Optional[Any] = None,
        **kwargs: Any,
    ):
        # one SeedSequence fans out to the cross-env multinomial (child 0)
        # and each sub-buffer (children 1..n)
        children = np.random.SeedSequence(seed).spawn(n_envs + 1)
        self._rng = np.random.default_rng(children[0])
        self._buffers: List[ReplayBuffer] = [
            buffer_cls(buffer_size, n_envs=1, obs_keys=obs_keys, seed=children[i + 1], **kwargs)
            for i in range(n_envs)
        ]
        self._n_envs = n_envs
        self._concat_along_axis = getattr(buffer_cls, "batch_axis", 1)

    def add(
        self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None, validate_args: bool = False
    ) -> None:
        indices = list(range(self._n_envs) if indices is None else indices)
        for slot, env_idx in enumerate(indices):
            self._buffers[env_idx].add({k: v[:, slot : slot + 1] for k, v in data.items()}, validate_args)

    def state_dict(self) -> Dict[str, Any]:
        return {"buffers": [b.state_dict() for b in self._buffers], "rng": self._rng.bit_generator.state}

    def checkpoint_state_dict(self) -> Dict[str, Any]:
        """Each sub-buffer's checkpoint state (its own truncation surgery)."""
        return {"buffers": [b.checkpoint_state_dict() for b in self._buffers], "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> "EnvIndependentReplayBuffer":
        if len(state["buffers"]) != len(self._buffers):
            raise ValueError(
                f"the checkpoint's buffer has {len(state['buffers'])} envs, this run {len(self._buffers)}: "
                "resume with the same env.num_envs"
            )
        for b, s in zip(self._buffers, state["buffers"]):
            b.load_state_dict(s)
        if state.get("rng") is not None:
            self._rng.bit_generator.state = state["rng"]
        return self

    def sample(self, batch_size: int, n_samples: int = 1, **kwargs: Any) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be > 0")
        ready = [b for b in self._buffers if b._full or b._pos > 0]
        if not ready:
            raise ValueError("No data in the buffer, cannot sample")
        split = self._rng.multinomial(batch_size, [1 / len(ready)] * len(ready))
        parts = [b.sample(int(bs), n_samples=n_samples, **kwargs) for b, bs in zip(ready, split) if bs > 0]
        axis = self._concat_along_axis
        return {k: np.concatenate([p[k] for p in parts], axis=axis) for k in parts[0]}
