"""``gym.spaces`` of the legacy gym stand-in: Box, Discrete and Dict with
gym 0.21's attributes (``low``, ``high``, ``shape``, ``dtype``, ``n``,
``spaces``; a plain dict's keys sorted, as gym's Dict sorts them)."""
from collections import OrderedDict

import numpy as np


class Space:
    def __init__(self, shape=None, dtype=None):
        self.shape = None if shape is None else tuple(shape)
        self.dtype = None if dtype is None else np.dtype(dtype)
        self.np_random = np.random.RandomState()

    def seed(self, seed=None):
        self.np_random = np.random.RandomState(seed)
        return [seed]

    def contains(self, x) -> bool:
        return True


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        super().__init__(shape, dtype)
        self.low = np.full(self.shape, low, dtype=self.dtype)
        self.high = np.full(self.shape, high, dtype=self.dtype)

    def sample(self):
        if np.issubdtype(self.dtype, np.integer):
            return self.np_random.randint(self.low, self.high + 1).astype(self.dtype)
        return self.np_random.uniform(self.low, self.high).astype(self.dtype)


class Discrete(Space):
    def __init__(self, n: int):
        super().__init__((), np.int64)
        self.n = int(n)

    def sample(self):
        return int(self.np_random.randint(self.n))


class Dict(Space):
    def __init__(self, spaces=None, **kwargs):
        spaces = dict(spaces or {}, **kwargs)
        if not isinstance(spaces, OrderedDict):
            spaces = OrderedDict(sorted(spaces.items()))
        self.spaces = spaces
        super().__init__(None, None)

    def __getitem__(self, key):
        return self.spaces[key]

    def __iter__(self):
        yield from self.spaces

    def __len__(self) -> int:
        return len(self.spaces)

    def keys(self):
        return self.spaces.keys()

    def sample(self):
        return OrderedDict((k, s.sample()) for k, s in self.spaces.items())
