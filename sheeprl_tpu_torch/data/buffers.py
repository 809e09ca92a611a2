"""Host-side replay buffers in numpy, optionally memory-mapped (the port's own
copy of ``ReplayBuffer``, ``SequentialReplayBuffer``,
``EnvIndependentReplayBuffer`` and ``EpisodeBuffer`` from
``sheeprl_tpu/data/buffers.py``).

``ReplayBuffer`` stores [buffer_size, n_envs, ...] per key, in memory or (with
``memmap``) in one ``<memmap_dir>/<key>.memmap`` file per key; samples come
back [n_samples, batch, ...]; ``SequentialReplayBuffer.sample`` returns
[n_samples, seq_len, batch, ...], gathered by the host C++ gather
(``data/native.py``) where it is built.

``state_dict``/``load_state_dict`` carry the stored rows, the write head and
the sampling generator's state; ``checkpoint_state_dict`` is the state a
resumable checkpoint holds (the row at the write head marked truncated), or,
with ``memmap_fast_resume`` on memmap storage, a reference to the flushed
files.
"""
from __future__ import annotations

import logging
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import native
from .memmap import MemmapArray


def _as_storage(shape: Sequence[int], dtype: Any, memmap: bool, memmap_dir: Optional[Path], key: str):
    if memmap:
        filename = None if memmap_dir is None else memmap_dir / f"{key}.memmap"
        return MemmapArray(shape, dtype=dtype, filename=filename)
    return np.zeros(shape, dtype=dtype)


class ReplayBuffer:
    """Circular dict buffer of shape [buffer_size, n_envs, ...] per key."""

    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        seed: Optional[Any] = None,
        memmap_fast_resume: bool = False,
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
        self._memmap = bool(memmap)
        self._memmap_dir = Path(memmap_dir) if memmap_dir is not None else None
        if self._memmap and self._memmap_dir is not None:
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        # checkpoints reference the flushed files instead of copying the rows
        self.memmap_fast_resume = bool(memmap_fast_resume)
        self._buf: Dict[str, Any] = {}
        self._pos = 0
        self._full = False
        # rows ever added: lets the device ring see that more than
        # buffer_size rows landed between two syncs (the write head aliases)
        self._added = 0

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def full(self) -> bool:
        return self._full

    @property
    def empty(self) -> bool:
        return len(self._buf) == 0

    def __contains__(self, key: str) -> bool:
        return key in self._buf

    def keys(self):
        return self._buf.keys()

    def __getitem__(self, key: str) -> np.ndarray:
        return np.asarray(self._buf[key])

    def _maybe_create(self, key: str, item_shape: Tuple[int, ...], dtype: Any) -> None:
        if key not in self._buf:
            self._buf[key] = _as_storage(
                (self._buffer_size, self._n_envs) + tuple(item_shape), dtype, self._memmap, self._memmap_dir, key
            )

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
            self._maybe_create(k, v.shape[2:], v.dtype)
        idxs = (self._pos + np.arange(t)) % self._buffer_size
        for k, v in data.items():
            if t >= self._buffer_size:
                self._buf[k][idxs[-self._buffer_size :]] = v[-self._buffer_size :]
            else:
                self._buf[k][idxs] = v
        if self._pos + t >= self._buffer_size:
            self._full = True
        self._pos = int((self._pos + t) % self._buffer_size)
        self._added += t

    def sample_indices(self, total: int) -> Tuple[np.ndarray, np.ndarray]:
        """``total`` uniform (row, env) index pairs over the stored rows, the
        JAX package's draw (shared with the device ring's gather, so host and
        device batches are the same rows)."""
        if not self._full and self._pos == 0:
            raise ValueError("No data in the buffer, cannot sample")
        idxs = self._rng.integers(0, self._buffer_size if self._full else self._pos, size=total)
        env_idxs = self._rng.integers(0, self._n_envs, size=total)
        return idxs, env_idxs

    def sample(self, batch_size: int, n_samples: int = 1, out: Optional[Dict[str, np.ndarray]] = None,
               **kwargs: Any) -> Dict[str, np.ndarray]:
        """A uniform sample, ``[n_samples, batch_size, ...]`` per key; the keys
        ``out`` holds are gathered into its arrays (cast to their dtype),
        which are returned."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be > 0")
        idxs, env_idxs = self.sample_indices(batch_size * n_samples)
        rows = idxs * self._n_envs + env_idxs
        result: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            arr = np.asarray(v)
            flat = arr.reshape(self._buffer_size * self._n_envs, *arr.shape[2:])
            dst = out.get(k) if out is not None else None
            if dst is None:
                result[k] = np.take(flat, rows, axis=0).reshape(n_samples, batch_size, *arr.shape[2:])
                continue
            view = dst.reshape(len(rows), *arr.shape[2:])
            if dst.dtype == flat.dtype:
                np.take(flat, rows, axis=0, out=view)
            else:
                view[...] = np.take(flat, rows, axis=0)
            result[k] = dst
        return result

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

    def _all_memmap(self) -> bool:
        return bool(self._buf) and all(isinstance(v, MemmapArray) for v in self._buf.values())

    def flush(self) -> None:
        """Flush memmap storage to its files (no-op in memory)."""
        for v in self._buf.values():
            if isinstance(v, MemmapArray):
                v.flush()

    def checkpoint_state_dict(self) -> Dict[str, Any]:
        """State for a resumable checkpoint. The envs are not saved, so the
        row at the current write position is marked truncated: a resumed
        sequential sample can never join the pre-save tail and the
        post-resume head into one trajectory. The live buffer keeps its
        flags (the surgery is on the copy).

        With ``memmap_fast_resume`` on memmap storage the state references
        the flushed files instead of copying them (the checkpoint resumes
        only where the run dir survives), and the surgery waits for
        ``load_state_dict``, so the live files stay untouched."""
        if self.memmap_fast_resume and self._memmap and self._all_memmap():
            self.flush()
            # the files now belong to the checkpoint: an owned MemmapArray
            # unlinks its file when it is collected
            for v in self._buf.values():
                v.has_ownership = False
            return {
                "__memmap_ref__": 1,
                "keys": {
                    k: {"filename": str(v.filename), "shape": tuple(int(s) for s in v.shape),
                        "dtype": str(np.dtype(v.dtype))}
                    for k, v in self._buf.items()
                },
                "size": self._buffer_size,
                "pos": self._pos,
                "full": self._full,
                "rng": self._rng.bit_generator.state,
                "truncate_last": bool("truncated" in self._buf and (self._full or self._pos > 0)),
            }
        state = self.state_dict()
        if "truncated" in state["buffer"] and (self._full or self._pos > 0):
            state["buffer"]["truncated"][(state["pos"] - 1) % self._buffer_size, :] = 1
        return state

    def _load_memmap_ref(self, state: Dict[str, Any]) -> "ReplayBuffer":
        """Rehydrate from a checkpoint that references memmap files: each
        file is copied into this buffer's own storage (the old run's files
        stay the old run's)."""
        for k, spec in state["keys"].items():
            shape = tuple(spec["shape"])
            if shape[:2] != (self._buffer_size, self._n_envs):
                raise ValueError(
                    f"the checkpoint's '{k}' is {shape}, this buffer ({self._buffer_size}, {self._n_envs}): "
                    "resume with the same buffer.size and env.num_envs"
                )
            if not os.path.exists(spec["filename"]):
                raise FileNotFoundError(
                    f"the checkpoint references the buffer file {spec['filename']} "
                    "(buffer.memmap_fast_resume=True keeps the rows in the run dir's memmap_buffer/): restore "
                    "the run dir or train with buffer.memmap_fast_resume=False"
                )
            src = np.memmap(spec["filename"], dtype=np.dtype(spec["dtype"]), mode="r", shape=shape)
            try:
                self._maybe_create(k, shape[2:], np.dtype(spec["dtype"]))
                self._buf[k][:] = src
            finally:
                del src
        self._pos = int(state["pos"])
        self._full = bool(state["full"])
        self._added = self._pos + (self._buffer_size if self._full else 0)
        if state.get("rng") is not None:
            self._rng.bit_generator.state = state["rng"]
        # the deferred surgery, on this buffer's copy
        if state.get("truncate_last") and "truncated" in self._buf:
            self._buf["truncated"][(self._pos - 1) % self._buffer_size, :] = 1
        return self

    def load_state_dict(self, state: Dict[str, Any]) -> "ReplayBuffer":
        if int(state["size"]) != self._buffer_size:
            raise ValueError(
                f"the checkpoint's buffer holds {state['size']} rows, this one {self._buffer_size}: resume with "
                "the same buffer.size"
            )
        if state.get("__memmap_ref__"):
            return self._load_memmap_ref(state)
        for k, v in state["buffer"].items():
            if v.shape[1] != self._n_envs:
                raise ValueError(f"the checkpoint's '{k}' has {v.shape[1]} envs, this buffer {self._n_envs}")
            stale = k in self._buf  # rows of this buffer's own past beyond the checkpoint's
            self._maybe_create(k, v.shape[2:], v.dtype)
            self._buf[k][: len(v)] = v
            if stale:
                self._buf[k][len(v):] = 0
        self._pos = int(state["pos"])
        self._full = bool(state["full"])
        self._added = self._pos + (self._buffer_size if self._full else 0)
        if state.get("rng") is not None:
            self._rng.bit_generator.state = state["rng"]
        return self


class SequentialReplayBuffer(ReplayBuffer):
    """Samples contiguous length-``sequence_length`` windows ignoring episode
    bounds. Returns [n_samples, seq_len, batch_size, ...]."""

    batch_axis: int = 2

    def sample_starts(self, total: int, sequence_length: int) -> np.ndarray:
        """``total`` valid window starts (shared with the device ring's
        gather, so host and device batches are the same rows)."""
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
        # flat (time, env) rows in the final [n_samples, L, batch] order: the
        # native gather writes the training layout at once
        flat_rows = np.ascontiguousarray(
            (seq * self._n_envs + env_idxs[:, None]).reshape(n_samples, batch_size, L).transpose(0, 2, 1),
            dtype=np.int64,
        )
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            arr = np.asarray(v)
            item = arr.shape[2:]
            gathered = native.gather_rows(
                arr.reshape(self._buffer_size * self._n_envs, *item), flat_rows, (n_samples, L, batch_size, *item)
            )
            if gathered is None:  # no native gather here: numpy's
                taken = arr[seq, env_idxs[:, None]].reshape(n_samples, batch_size, L, *item)
                gathered = np.ascontiguousarray(np.swapaxes(taken, 1, 2))
            out[k] = gathered
        return out


class EnvIndependentReplayBuffer:
    """One sub-buffer per env: per-env ``add(indices)`` (Dreamer's per-env
    reset rows) and multinomial cross-env sampling. With ``memmap`` each
    sub-buffer keeps its files in ``<memmap_dir>/env_<i>``."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        buffer_cls: type = SequentialReplayBuffer,
        seed: Optional[Any] = None,
        **kwargs: Any,
    ):
        mdir = Path(memmap_dir) if memmap_dir is not None else None
        # one SeedSequence fans out to the cross-env multinomial (child 0)
        # and each sub-buffer (children 1..n)
        children = np.random.SeedSequence(seed).spawn(n_envs + 1)
        self._rng = np.random.default_rng(children[0])
        self._buffers: List[ReplayBuffer] = [
            buffer_cls(
                buffer_size, n_envs=1, obs_keys=obs_keys, memmap=memmap,
                memmap_dir=None if mdir is None else mdir / f"env_{i}", seed=children[i + 1], **kwargs,
            )
            for i in range(n_envs)
        ]
        self._n_envs = n_envs
        self._buffer_size = int(buffer_size)
        self._concat_along_axis = getattr(buffer_cls, "batch_axis", 1)
        # callables (env_idx, row) told of a row edited in place (the device ring)
        self.edit_hooks: List[Callable[[int, int], None]] = []

    @property
    def buffer(self) -> List[ReplayBuffer]:
        return self._buffers

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    def add(
        self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None, validate_args: bool = False
    ) -> None:
        indices = list(range(self._n_envs) if indices is None else indices)
        for slot, env_idx in enumerate(indices):
            self._buffers[env_idx].add({k: v[:, slot : slot + 1] for k, v in data.items()}, validate_args)

    def mark_restart(self, env_idx: int) -> None:
        """After an env restarted in flight (``RestartOnException`` without an
        episode end), rewrite that env's last row as a truncation boundary:
        terminated 0, truncated 1, is_first 0."""
        b = self._buffers[env_idx]
        idx = (b._pos - 1) % b.buffer_size
        for key, value in (("terminated", 0), ("truncated", 1), ("is_first", 0)):
            if key in b:
                b._buf[key][idx] = value
        for hook in self.edit_hooks:
            hook(env_idx, idx)

    def flush(self) -> None:
        for b in self._buffers:
            b.flush()

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

    def sample(
        self, batch_size: int, n_samples: int = 1, out: Optional[Dict[str, np.ndarray]] = None, **kwargs: Any
    ) -> Dict[str, np.ndarray]:
        """Sample from the envs with data (a multinomial split of the batch);
        with ``out`` the batch is written into those arrays (the staged
        prefetcher's pinned buffers) and they are returned."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be > 0")
        ready = [b for b in self._buffers if b._full or b._pos > 0]
        if not ready:
            raise ValueError("No data in the buffer, cannot sample")
        split = self._rng.multinomial(batch_size, [1 / len(ready)] * len(ready))
        parts = [b.sample(int(bs), n_samples=n_samples, **kwargs) for b, bs in zip(ready, split) if bs > 0]
        axis = self._concat_along_axis
        if out is None:
            return {k: np.concatenate([p[k] for p in parts], axis=axis) for k in parts[0]}
        for k in parts[0]:
            np.concatenate([p[k] for p in parts], axis=axis, out=out[k])
        return out


class EpisodeBuffer:
    """Whole episodes: ``add`` appends [T, n_envs, ...] rows to each env's open
    episode and commits it at ``terminated | truncated`` (an episode shorter
    than ``minimum_episode_length`` is dropped); the oldest episodes are
    evicted while more than ``buffer_size`` rows are stored. ``sample``
    draws [n_samples, seq_len, batch, ...] windows: an episode with
    probability proportional to its length among those at least
    ``sequence_length`` long, then a start, uniform or (``prioritize_ends``)
    ``min(uniform over the episode, last valid start)`` so that episode ends
    are drawn more often. The draws are the JAX package's, from the same
    numpy generator, so one seed samples the same windows.

    With ``memmap`` each committed episode moves to
    ``<memmap_dir>/episode_<n>/<key>.memmap``, and an evicted episode's
    directory is removed. ``checkpoint_state_dict`` holds the committed
    episodes and the generator (the open ones are dropped: their envs are
    not checkpointed). Not sampling from anything yet raises ``ValueError``,
    which the staged prefetcher takes as "nothing to stage"."""

    def __init__(
        self,
        buffer_size: int,
        minimum_episode_length: int = 1,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        prioritize_ends: bool = False,
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        seed: Optional[Any] = None,
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"buffer_size must be > 0, got {buffer_size}")
        if minimum_episode_length <= 0 or minimum_episode_length > buffer_size:
            raise ValueError(f"minimum_episode_length must be in [1, {buffer_size}], got {minimum_episode_length}")
        self._buffer_size = int(buffer_size)
        self._min_len = int(minimum_episode_length)
        self._n_envs = int(n_envs)
        self._obs_keys = tuple(obs_keys)
        self._prioritize_ends = bool(prioritize_ends)
        self._memmap = bool(memmap)
        self._memmap_dir = Path(memmap_dir) if memmap_dir is not None else None
        self._rng = np.random.default_rng(seed)
        self._episodes: List[Dict[str, Any]] = []
        self._open: List[Optional[Dict[str, List[np.ndarray]]]] = [None] * self._n_envs
        self._cum_len = 0
        self._episode_counter = 0  # a distinct memmap dir per committed episode

    @property
    def buffer(self) -> List[Dict[str, Any]]:
        return self._episodes

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    def __len__(self) -> int:
        return self._cum_len

    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None,
            validate_args: bool = False) -> None:
        """Append [T, len(indices), ...] rows to the envs ``indices`` (all
        envs by default); ``data`` must hold ``terminated`` and ``truncated``."""
        if "terminated" not in data or "truncated" not in data:
            raise RuntimeError("EpisodeBuffer.add requires 'terminated' and 'truncated' keys")
        t = next(iter(data.values())).shape[0]
        for slot, env_idx in enumerate(range(self._n_envs) if indices is None else indices):
            if self._open[env_idx] is None:
                self._open[env_idx] = {k: [] for k in data}
            open_ep = self._open[env_idx]
            for k in data:
                open_ep.setdefault(k, [])
            done = (np.asarray(data["terminated"][:, slot]) + np.asarray(data["truncated"][:, slot])).reshape(t) > 0
            for step in range(t):
                for k, v in data.items():
                    open_ep[k].append(np.asarray(v[step, slot]))
                if done[step]:
                    self._commit(env_idx)
                    self._open[env_idx] = open_ep = {k: [] for k in data}

    def _commit(self, env_idx: int) -> None:
        open_ep = self._open[env_idx]
        length = len(next(iter(open_ep.values()), []))
        if length < self._min_len:
            return
        if length > self._buffer_size:
            raise RuntimeError(f"Episode of length {length} exceeds buffer_size {self._buffer_size}")
        ep = {k: np.stack(v, axis=0) for k, v in open_ep.items() if v}
        if self._memmap:
            ep = self._memmap_episode(ep)
        self._episodes.append(ep)
        self._cum_len += length
        while self._cum_len > self._buffer_size and self._episodes:
            old = self._episodes.pop(0)
            self._cum_len -= len(next(iter(old.values())))
            self._drop_episode_dir(old)

    def _memmap_episode(self, ep: Dict[str, np.ndarray]) -> Dict[str, Any]:
        ep_dir = None if self._memmap_dir is None else self._memmap_dir / f"episode_{self._episode_counter}"
        self._episode_counter += 1
        return {k: MemmapArray.from_array(v, filename=None if ep_dir is None else ep_dir / f"{k}.memmap")
                for k, v in ep.items()}

    def _drop_episode_dir(self, old: Dict[str, Any]) -> None:
        """Remove an evicted episode's directory (a resumed buffer re-opens
        files it does not own, so ownership alone would leak them)."""
        if not self._memmap or self._memmap_dir is None:
            return
        first = next(iter(old.values()), None)
        ep_dir = Path(first.filename).parent if isinstance(first, MemmapArray) else None
        old.clear()
        del first
        if ep_dir is not None and ep_dir != self._memmap_dir:
            try:
                shutil.rmtree(ep_dir)
            except OSError as err:
                logging.getLogger(__name__).warning("could not remove evicted episode dir %s: %s", ep_dir, err)

    def sample(self, batch_size: int, n_samples: int = 1, sequence_length: int = 1,
               prioritize_ends: Optional[bool] = None, out: Optional[Dict[str, np.ndarray]] = None,
               **kwargs: Any) -> Dict[str, np.ndarray]:
        """[n_samples, sequence_length, batch_size, ...] windows of stored
        episodes; with ``out`` they are written into those arrays (the staged
        prefetcher's pinned buffers), which are returned."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be > 0")
        if prioritize_ends is None:
            prioritize_ends = self._prioritize_ends
        valid = [ep for ep in self._episodes if len(next(iter(ep.values()))) >= sequence_length]
        if not valid:
            raise ValueError(f"No episodes of length >= {sequence_length} to sample")
        lengths = np.array([len(next(iter(ep.values()))) for ep in valid])
        ep_idx = self._rng.choice(len(valid), size=batch_size * n_samples, p=lengths / lengths.sum())
        samples: Dict[str, List[np.ndarray]] = {}
        for i in ep_idx:
            ep, ep_len = valid[i], lengths[i]
            upper = ep_len - sequence_length + 1
            if prioritize_ends:
                start = min(int(self._rng.integers(0, ep_len)), upper - 1)
            else:
                start = int(self._rng.integers(0, upper))
            for k, v in ep.items():
                samples.setdefault(k, []).append(v[start : start + sequence_length])
        result: Dict[str, np.ndarray] = {}
        for k, vs in samples.items():
            arr = np.stack(vs, axis=0)  # [total, L, ...]
            arr = np.swapaxes(arr.reshape(n_samples, batch_size, sequence_length, *arr.shape[2:]), 1, 2)
            if out is not None:
                np.copyto(out[k], arr, casting="unsafe")
                result[k] = out[k]
            else:
                result[k] = np.ascontiguousarray(arr)
        return result

    def state_dict(self) -> Dict[str, Any]:
        return {
            # np.array() also materialises memmap-backed episodes
            "episodes": [{k: np.array(v) for k, v in ep.items()} for ep in self._episodes],
            "open": [None if o is None else {k: [x.copy() for x in v] for k, v in o.items()} for o in self._open],
            "cum_len": self._cum_len,
            "rng": self._rng.bit_generator.state,
        }

    def checkpoint_state_dict(self) -> Dict[str, Any]:
        """The committed episodes and the generator; the open episodes are
        dropped (their envs are not in the checkpoint)."""
        state = self.state_dict()
        state["open"] = [None for _ in state["open"]]
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> "EpisodeBuffer":
        if len(state["open"]) != self._n_envs:
            raise ValueError(
                f"the checkpoint's buffer has {len(state['open'])} envs, this run {self._n_envs}: "
                "resume with the same env.num_envs"
            )
        episodes = state["episodes"]
        if self._memmap:
            # a memmap buffer stays on disk across a resume; re-opened files
            # are reclaimed on eviction
            episodes = [self._memmap_episode({k: np.asarray(v) for k, v in ep.items()}) for ep in episodes]
            for ep in episodes:
                for arr in ep.values():
                    arr.has_ownership = True
        self._episodes = episodes
        self._open = list(state["open"])
        self._cum_len = int(state["cum_len"])
        if state.get("rng") is not None:
            self._rng.bit_generator.state = state["rng"]
        return self


def gather_env_blocks(states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """One buffer's checkpoint state over all envs from the ranks' states of
    their env blocks, in rank order (``parallel/mesh.py``): an
    ``EnvIndependentReplayBuffer``'s sub-buffers are listed block after
    block, a ``ReplayBuffer``'s rows joined along the env axis (the ranks add
    in lockstep, so their write heads agree). What the JAX package's single
    buffer over ``env.num_envs`` envs holds; each rank's sampling generator
    rides along under ``rank_rngs``. ``EpisodeBuffer`` states, whose
    episodes have no env layout, are kept side by side (``rank_states``)."""
    states = list(states)
    if len(states) == 1:
        return states[0]
    if "episodes" in states[0]:
        return {"rank_states": states}
    if any(s.get("__memmap_ref__") or any(b.get("__memmap_ref__") for b in s.get("buffers", ())) for s in states):
        raise NotImplementedError("buffer.memmap_fast_resume on N ranks: each rank's memmap files are its own, "
                                  "so a checkpoint cannot reference them")
    rngs = [s.get("rng") for s in states]
    if "buffers" in states[0]:
        return {"buffers": [b for s in states for b in s["buffers"]], "rng": rngs[0], "rank_rngs": rngs}
    if len({(int(s["pos"]), bool(s["full"])) for s in states}) != 1:
        raise RuntimeError("the ranks' replay buffers are out of step: "
                           f"{[(s['pos'], s['full']) for s in states]}")
    return {**states[0], "buffer": {k: np.concatenate([s["buffer"][k] for s in states], axis=1)
                                    for k in states[0]["buffer"]}, "rank_rngs": rngs}


def env_block(state: Dict[str, Any], rank: int, world_size: int) -> Dict[str, Any]:
    """Rank ``rank``'s share of ``gather_env_blocks``' state: its env block
    and its own sampling generator (``state`` itself at world size 1; a state
    written on one rank leaves each rank its own generator). Episode buffers
    come back only on as many ranks as wrote them."""
    if "rank_states" in state:
        if len(state["rank_states"]) != world_size:
            raise NotImplementedError(f"the episode buffers were written on {len(state['rank_states'])} ranks and "
                                      f"this run has {world_size}: they resume at the same world size only")
        return state["rank_states"][rank]
    if world_size == 1:
        return state
    if "episodes" in state:
        raise NotImplementedError(f"an episode buffer written on one rank cannot be split over {world_size} ranks")
    rngs = state.get("rank_rngs")
    rng = rngs[rank] if rngs is not None and len(rngs) == world_size else None  # else the buffer's own seed
    if "buffers" in state:
        epd = len(state["buffers"]) // world_size
        return {"buffers": state["buffers"][rank * epd:(rank + 1) * epd], "rng": rng}
    n_envs = next(iter(state["buffer"].values())).shape[1]
    epd = n_envs // world_size
    return {**{k: v for k, v in state.items() if k != "rank_rngs"}, "rng": rng,
            "buffer": {k: v[:, rank * epd:(rank + 1) * epd] for k, v in state["buffer"].items()}}
