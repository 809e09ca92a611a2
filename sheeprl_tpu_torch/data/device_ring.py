"""A replay ring in device memory: rows cross to the card once, batches are
gathered there (the single-device part of ``sheeprl_tpu/data/device_ring.py``),
for the sequential replay of the Dreamer loop (``DeviceRingPrefetcher``) and
the uniform replay of the SAC family (``DeviceUniformRingPrefetcher``).

The staged prefetcher copies every sampled batch to the card, a DreamerV3-S
burst batch being 16 windows of 64 steps of 64×64×3 uint8 frames, about
12.6 MB. Every such batch is a gather from rows the host already holds; the
ring keeps a device mirror of the ``EnvIndependentReplayBuffer`` so that a
row crosses once, when it is added:

* ``ring[key]`` is a ``[buffer_size, n_envs, ...]`` tensor on the card laid
  out like the host buffer (env ``e``'s row ``t`` at ``ring[key][t, e]``), at
  the stored dtypes (rgb stays uint8);
* ``sync()`` ships only the rows added or edited since the last sync, padded
  to a multiple of a fixed bucket (the padding repeats the first row, so its
  writes are no-ops);
* sampling draws window starts on the host with the host buffer's own index
  math (``SequentialReplayBuffer.sample_starts``) and gathers the batch on
  the card: for the same generator state a ring batch equals the host
  batch bit for bit.

The uniform ring mirrors a plain ``ReplayBuffer`` the same way, shipping whole
time steps (the buffer adds all envs in lockstep), and gathers ``[G, B, ...]``
batches with the host buffer's own index draw (``ReplayBuffer.sample_indices``).

The host buffer stays the source of truth for checkpoints and restarts: an
in-place edit (``mark_restart`` rewrites a row's flags) reaches the ring
through ``mark_dirty``, and ``resync()`` rebuilds it after a checkpoint load.
The scatter and the gather are PyTorch indexing ops. On a multi-axis mesh
(fsdp or tp > 1) the sequential feed stays host-staged, with the JAX
package's message (``_pure_dp_or_staged``).
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import device as device_counters

from .buffers import EnvIndependentReplayBuffer, EpisodeBuffer, ReplayBuffer, SequentialReplayBuffer
from .prefetch import StagedPrefetcher


def _scatter_rows(ring: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor], t_idx: torch.Tensor,
                  e_idx: torch.Tensor) -> None:
    for k, r in ring.items():
        r.index_put_((t_idx, e_idx), rows[k])


def _gather_batch(ring: Dict[str, torch.Tensor], t_idx: torch.Tensor, e_idx: torch.Tensor,
                  f32_keys: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    # t_idx [G, L, B] with e_idx [B] broadcasts to [G, L, B, *item]
    out = {k: r[t_idx, e_idx] for k, r in ring.items()}
    return {k: v.float() if k in f32_keys else v for k, v in out.items()}


class DeviceRingPrefetcher:
    """``stage``/``take`` prefetcher serving batches from a device mirror of
    an ``EnvIndependentReplayBuffer`` of sequential sub-buffers. The gather
    runs on the consumer's current stream."""

    def __init__(self, rb: EnvIndependentReplayBuffer, batch_size: int, sequence_length: int,
                 cnn_keys: Sequence[str] = (), device: Any = "cuda", bucket: int = 8):
        for b in rb.buffer:
            if not isinstance(b, SequentialReplayBuffer):
                raise TypeError(f"DeviceRingPrefetcher mirrors sequential sub-buffers, got {type(b).__name__}")
        self._rb = rb
        self._batch = int(batch_size)
        self._seq = int(sequence_length)
        self._cnn_keys = tuple(cnn_keys)
        self.device = torch.device(device)
        self._bucket = int(bucket)
        self._ring: Optional[Dict[str, torch.Tensor]] = None
        # per env, the rows ever added at the last sync (never wraps, so a
        # backlog of buffer_size rows or more is seen)
        self._synced_added: List[int] = [0] * rb.n_envs
        self._staged: Optional[tuple] = None
        self._last_idx: Optional[tuple] = None  # (t_idx, env_order) of the last gather
        self._dirty_rows: List[Tuple[int, int]] = []
        self.synced_rows = 0  # rows shipped (padding excluded)
        self.synced_bytes = 0  # bytes shipped (padding included)
        rb.edit_hooks.append(self.mark_dirty)

    @property
    def ring(self) -> Optional[Dict[str, torch.Tensor]]:
        return self._ring

    def mark_dirty(self, env_idx: int, row: int) -> None:
        """Re-ship a row the host edited in place (restart surgery rewrites
        the flags of a row the ring may hold already)."""
        self._dirty_rows.append((int(env_idx), int(row) % self._rb.buffer_size))

    def _ensure_ring(self) -> None:
        if self._ring is not None:
            return
        proto = next(b for b in self._rb.buffer if not b.empty)
        size, n_envs = self._rb.buffer_size, self._rb.n_envs
        self._ring = {
            k: torch.zeros((size, n_envs) + proto[k].shape[2:], dtype=torch.from_numpy(proto[k][:0]).dtype,
                           device=self.device)
            for k in proto.keys()
        }

    def _pending_rows(self) -> List[Tuple[int, int]]:
        """(env, row) pairs added or edited since the last sync, oldest first
        per env."""
        rows: List[Tuple[int, int]] = []
        size = self._rb.buffer_size
        for e, b in enumerate(self._rb.buffer):
            if b.empty:
                continue
            added, pos = b._added, b._pos
            delta = added - self._synced_added[e]
            if delta >= size or (self._synced_added[e] == 0 and b.full):
                # first sync, or more rows landed than the ring holds: all
                # that is stored (the window ending at pos)
                start = pos if b.full else 0
                n = size if b.full else pos
                rows.extend((e, (start + i) % size) for i in range(n))
            else:
                rows.extend((e, (pos - delta + i) % size) for i in range(delta))
            self._synced_added[e] = added
        rows.extend(self._dirty_rows)
        self._dirty_rows.clear()
        return rows

    def sync(self) -> None:
        """Ship the new and edited host rows into the ring."""
        if all(b.empty for b in self._rb.buffer):
            return
        self._ensure_ring()
        rows = self._pending_rows()
        if not rows:
            return
        n = len(rows)
        pad = -(-n // self._bucket) * self._bucket - n
        take = np.concatenate([np.arange(n), np.zeros(pad, np.int64)])  # the padding repeats row 0
        t_np = np.asarray([r for _, r in rows], np.int64)[take]
        e_np = np.asarray([e for e, _ in rows], np.int64)[take]
        by_env: Dict[int, List[int]] = {}
        for i, (e, _) in enumerate(rows):
            by_env.setdefault(e, []).append(i)
        data: Dict[str, torch.Tensor] = {}
        for k, r in self._ring.items():
            out = np.empty((n,) + tuple(r.shape[2:]), dtype=self._rb.buffer[rows[0][0]][k].dtype)
            for e, slots in by_env.items():
                out[slots] = self._rb.buffer[e][k][[rows[i][1] for i in slots], 0]
            out = out[take]
            data[k] = torch.from_numpy(out).to(self.device)
            self.synced_bytes += out.nbytes
        self.synced_rows += n
        t_idx, e_idx = torch.from_numpy(t_np).to(self.device), torch.from_numpy(e_np).to(self.device)
        if self.device.type == "cuda":
            device_counters.record_h2d(*data.values(), t_idx, e_idx)
        _scatter_rows(self._ring, data, t_idx, e_idx)

    def _sample_indices(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        """The host buffer's index draw (``EnvIndependentReplayBuffer.sample``):
        the multinomial split over the envs with data, then each env's
        window starts. Returns (t_idx [g, L, B], env_order [B])."""
        rb, L, B = self._rb, self._seq, self._batch
        ready = [(e, b) for e, b in enumerate(rb.buffer) if b.full or b._pos > 0]
        if not ready:
            raise ValueError("No data in the buffer, cannot sample")
        split = rb._rng.multinomial(B, [1 / len(ready)] * len(ready))
        starts_cols: List[np.ndarray] = []
        env_order: List[int] = []
        for (e, b), bs in zip(ready, split):
            if bs == 0:
                continue
            starts_cols.append(b.sample_starts(int(bs) * g, L).reshape(g, int(bs)))
            env_order.extend([e] * int(bs))
        starts = np.concatenate(starts_cols, axis=1)  # [g, B]
        t_idx = (starts[:, None, :] + np.arange(L)[None, :, None]) % rb.buffer_size
        return t_idx.astype(np.int64), np.asarray(env_order, np.int64)

    def _f32_keys(self) -> Tuple[str, ...]:
        return tuple(k for k, r in self._ring.items() if k not in self._cnn_keys and r.dtype != torch.float32)

    def _gather(self, g: int) -> Dict[str, torch.Tensor]:
        self.sync()
        t_idx, env_order = self._sample_indices(g)
        self._last_idx = (t_idx, env_order)
        t_dev, e_dev = torch.from_numpy(t_idx).to(self.device), torch.from_numpy(env_order).to(self.device)
        if self.device.type == "cuda":
            device_counters.record_h2d(t_dev, e_dev)
        return _gather_batch(self._ring, t_dev, e_dev, self._f32_keys())

    def stage(self, g: int) -> None:
        """Launch the next batch's gather now (nothing at the warmup
        boundary, where the buffer cannot serve it yet)."""
        if g <= 0:
            self._staged = None
            return
        try:
            self._staged = (g, self._gather(g))
        except ValueError:
            self._staged = None

    def take(self, g: int) -> Dict[str, torch.Tensor]:
        """The staged batch if it was staged for ``g``, else a fresh gather."""
        staged, self._staged = self._staged, None
        if staged is not None and staged[0] == g:
            return staged[1]
        return self._gather(g)

    def resync(self) -> None:
        """Forget the mirror; the next use rebuilds it from the host buffer
        (after a checkpoint load rewrote it)."""
        self._ring = None
        self._synced_added = [0] * self._rb.n_envs
        self._staged = None
        self._dirty_rows.clear()


def _scatter_steps(ring: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor], t_idx: torch.Tensor) -> None:
    # one scatter row covers all envs of a time step
    for k, r in ring.items():
        r.index_copy_(0, t_idx, rows[k])


def _gather_uniform(ring: Dict[str, torch.Tensor], t_idx: torch.Tensor, e_idx: torch.Tensor, g: int, batch: int,
                    f32_keys: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    out = {k: r[t_idx, e_idx].reshape(g, batch, *r.shape[2:]) for k, r in ring.items()}
    return {k: v.float() if k in f32_keys else v for k, v in out.items()}


class DeviceUniformRingPrefetcher:
    """``stage``/``take`` prefetcher serving uniform ``[G, B, ...]`` batches
    (the SAC family's) from a device mirror of a plain ``ReplayBuffer``.
    ``cnn_keys`` stay at their stored dtype (uint8 images; SAC-AE lists the
    ``next_`` frames it stores too), the other keys come as f32."""

    def __init__(self, rb: ReplayBuffer, batch_size: int, cnn_keys: Sequence[str] = (), device: Any = "cuda",
                 bucket: int = 8):
        self._rb = rb
        self._batch = int(batch_size)
        self._cnn_keys = tuple(cnn_keys)
        self.device = torch.device(device)
        self._bucket = int(bucket)
        self._ring: Optional[Dict[str, torch.Tensor]] = None
        self._synced_added = 0  # rows ever added at the last sync
        self._staged: Optional[tuple] = None
        self.synced_rows = 0  # time steps shipped (padding excluded)

    @property
    def ring(self) -> Optional[Dict[str, torch.Tensor]]:
        return self._ring

    def _ensure_ring(self) -> None:
        if self._ring is not None:
            return
        b = self._rb
        self._ring = {k: torch.zeros((b.buffer_size, b._n_envs) + b[k].shape[2:],
                                     dtype=torch.from_numpy(b[k][:0]).dtype, device=self.device) for k in b.keys()}

    def sync(self) -> None:
        """Ship the time steps added since the last sync into the ring (all
        that is stored when more landed than the ring holds)."""
        b = self._rb
        if b.empty:
            return
        self._ensure_ring()
        size = b.buffer_size
        delta = b._added - self._synced_added
        if delta <= 0:
            return
        if delta >= size:
            steps = [(b._pos + i) % size for i in range(size)] if b.full else list(range(b._pos))
        else:
            steps = [(b._pos - delta + i) % size for i in range(delta)]
        self._synced_added = b._added
        n = len(steps)
        pad = -(-n // self._bucket) * self._bucket - n
        # the padding repeats the first step, so its writes are no-ops
        t_np = np.asarray(steps + [steps[0]] * pad, np.int64)
        data: Dict[str, torch.Tensor] = {}
        for k in self._ring:
            data[k] = torch.from_numpy(np.ascontiguousarray(b[k][t_np])).to(self.device)
        self.synced_rows += n
        t_idx = torch.from_numpy(t_np).to(self.device)
        if self.device.type == "cuda":
            device_counters.record_h2d(*data.values(), t_idx)
        _scatter_steps(self._ring, data, t_idx)

    def _f32_keys(self) -> Tuple[str, ...]:
        return tuple(k for k, r in self._ring.items() if k not in self._cnn_keys and r.dtype != torch.float32)

    def _gather(self, g: int) -> Dict[str, torch.Tensor]:
        self.sync()
        if self._ring is None:
            raise ValueError("No data in the buffer, cannot sample")
        idxs, env_idxs = self._rb.sample_indices(self._batch * g)
        t_dev, e_dev = torch.from_numpy(idxs).to(self.device), torch.from_numpy(env_idxs).to(self.device)
        if self.device.type == "cuda":
            device_counters.record_h2d(t_dev, e_dev)
        return _gather_uniform(self._ring, t_dev, e_dev, g, self._batch, self._f32_keys())

    def stage(self, g: int) -> None:
        """Launch the next batch's gather now (nothing at the warmup
        boundary, where the buffer cannot serve it yet)."""
        if g <= 0:
            self._staged = None
            return
        try:
            self._staged = (g, self._gather(g))
        except ValueError:
            self._staged = None

    def take(self, g: int) -> Dict[str, torch.Tensor]:
        """The staged batch if it was staged for ``g``, else a fresh gather."""
        staged, self._staged = self._staged, None
        if staged is not None and staged[0] == g:
            return staged[1]
        return self._gather(g)


def _ring_mode(cfg: Any) -> str:
    """``buffer.device_cache``: YAML booleans arrive as bools, so ``false``
    must turn the ring off, not fall through to ``auto``."""
    raw = cfg.select("buffer.device_cache", "auto")
    mode = "auto" if raw is None else str(raw).lower()
    if mode not in ("auto", "true", "false"):
        raise ValueError(f"buffer.device_cache must be auto|true|false, got '{raw}'")
    return mode


def _use_ring(cfg: Any, device: torch.device, row_bytes_hint: Optional[int], rb_rows: int) -> bool:
    """``true`` forces the ring, ``false`` the staged prefetcher; ``auto``
    takes the ring on a card when the mirrored buffer fits
    ``buffer.device_cache_max_bytes``."""
    mode = _ring_mode(cfg)
    if mode != "auto":
        return mode == "true"
    cap = int(cfg.select("buffer.device_cache_max_bytes", 6_000_000_000) or 0)
    return torch.device(device).type != "cpu" and (row_bytes_hint or 0) * rb_rows <= cap


def _pure_dp_or_staged(cfg: Any) -> bool:
    """Whether the run's mesh takes the ring: a multi-axis mesh (fsdp or tp >
    1) stays host-staged, as the JAX package's sharded ring does (its
    message; under a forced ``buffer.device_cache=true`` it raises)."""
    from ..parallel.mesh import active

    dist = active()
    if dist is None or dist.is_pure_dp:
        return True
    msg = (f"sharded device ring is pure-dp only (mesh is dp={dist.dp} fsdp={dist.fsdp} tp={dist.tp}); "
           "multi-axis meshes stay host-staged")
    if _ring_mode(cfg) == "true":
        raise ValueError(msg)
    print(f"[device_ring] {msg}; falling back to host-staged batches", file=sys.stderr)
    return False


def estimate_row_bytes(obs_space: Any, act_dim: int) -> int:
    """Bytes one (time, env) replay row takes in the ring: the observations
    at their stored dtypes (images stay uint8), the action, and the four f32
    scalars (reward, terminated, truncated, is_first)."""
    total = 0
    for space in obs_space.spaces.values():
        total += int(np.prod(space.shape)) * np.dtype(space.dtype).itemsize
    return total + 4 * int(act_dim) + 4 * 4


def make_sequential_prefetcher(cfg: Any, device: torch.device, rb: EnvIndependentReplayBuffer, batch_size: int,
                               sequence_length: int, cnn_keys: Sequence[str] = (),
                               row_bytes_hint: Optional[int] = None):
    """The prefetcher for the sequential-replay (Dreamer) loops: the device
    ring where ``_use_ring`` takes it, else the staged prefetcher. An
    ``EpisodeBuffer`` always takes the staged prefetcher (the ring mirrors
    the sequential buffer's rows; the JAX package refuses it the same way).
    Prints which, with the mirror's size, to stderr."""
    cnn_keys = tuple(cnn_keys)
    episodic = isinstance(rb, EpisodeBuffer)
    rows = rb.buffer_size if episodic else rb.buffer_size * rb.n_envs

    def host_sample(g: int, out: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
        s = rb.sample(batch_size, sequence_length=sequence_length, n_samples=g, out=out)
        return {k: v if k in cnn_keys else np.asarray(v, np.float32) for k, v in s.items()}

    if not episodic and _use_ring(cfg, device, row_bytes_hint, rows) and _pure_dp_or_staged(cfg):
        pf = DeviceRingPrefetcher(rb, batch_size, sequence_length, cnn_keys=cnn_keys, device=device)
    else:
        pf = StagedPrefetcher(host_sample, device)
    print(f"[prefetch] {type(pf).__name__} (buffer.device_cache={_ring_mode(cfg)}, "
          f"mirror {(row_bytes_hint or 0) * rows} bytes)", file=sys.stderr, flush=True)
    return pf


def make_uniform_prefetcher(cfg: Any, device: torch.device, rb: ReplayBuffer, batch_size: int,
                            cnn_keys: Sequence[str] = (), row_bytes_hint: Optional[int] = None):
    """The prefetcher for the uniform-replay (SAC family) loops: the device
    ring under the same ``buffer.device_cache`` policy as the sequential
    path, else host samples staged one burst ahead through pinned memory.
    Both serve ``[G, B, ...]`` batches, ``cnn_keys`` uint8 and the rest f32,
    and for one generator state the same batch bit for bit. Prints which, with
    the mirror's size, to stderr."""
    cnn_keys = tuple(cnn_keys)
    rows = rb.buffer_size * rb._n_envs

    def host_sample(g: int, out: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
        s = rb.sample(batch_size * g, out=out)
        if out is not None:  # a pinned slot's [g, B, ...] arrays, of the dtypes below
            return s
        return {k: (v if k in cnn_keys else np.asarray(v, np.float32)).reshape(g, batch_size, *v.shape[2:])
                for k, v in s.items()}

    if _use_ring(cfg, device, row_bytes_hint, rows):
        pf = DeviceUniformRingPrefetcher(rb, batch_size, cnn_keys=cnn_keys, device=device)
    else:
        pf = StagedPrefetcher(host_sample, device)
    print(f"[prefetch] {type(pf).__name__} (buffer.device_cache={_ring_mode(cfg)}, "
          f"mirror {(row_bytes_hint or 0) * rows} bytes)", file=sys.stderr, flush=True)
    return pf
