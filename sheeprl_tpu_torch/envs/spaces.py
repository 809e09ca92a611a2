"""Minimal observation/action spaces with the gymnasium interface the port
uses (``shape``, ``dtype``, ``sample``, ``seed``, ``n``, ``nvec``, dict
indexing), so the port runs where gymnasium is not installed."""
from __future__ import annotations

from typing import Dict as TDict
from typing import Optional, Sequence

import numpy as np


class Space:
    def __init__(self, shape=(), dtype=None, seed: Optional[int] = None):
        self.shape = tuple(shape)
        self.dtype = None if dtype is None else np.dtype(dtype)
        self._rng = np.random.default_rng(seed)

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.default_rng(seed)

    def sample(self):
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape: Sequence[int], dtype=np.float32, seed: Optional[int] = None):
        super().__init__(shape, dtype, seed)
        self.low = np.full(self.shape, low, dtype=self.dtype)
        self.high = np.full(self.shape, high, dtype=self.dtype)

    def sample(self) -> np.ndarray:
        if np.issubdtype(self.dtype, np.integer):
            return self._rng.integers(self.low, self.high, endpoint=True, dtype=self.dtype)
        return self._rng.uniform(self.low, self.high).astype(self.dtype)


class Discrete(Space):
    def __init__(self, n: int, seed: Optional[int] = None):
        super().__init__((), np.int64, seed)
        self.n = int(n)

    def sample(self) -> np.int64:
        return np.int64(self._rng.integers(self.n))


class MultiDiscrete(Space):
    def __init__(self, nvec: Sequence[int], seed: Optional[int] = None):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        super().__init__(self.nvec.shape, np.int64, seed)

    def sample(self) -> np.ndarray:
        return self._rng.integers(0, self.nvec).astype(np.int64)


class Dict(Space):
    def __init__(self, spaces: TDict[str, Space]):
        super().__init__()
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def keys(self):
        return self.spaces.keys()

    def seed(self, seed: Optional[int] = None) -> None:
        for i, s in enumerate(self.spaces.values()):
            s.seed(None if seed is None else seed + i)

    def sample(self):
        return {k: s.sample() for k, s in self.spaces.items()}
