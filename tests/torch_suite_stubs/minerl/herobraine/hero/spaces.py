"""``minerl.herobraine.hero.spaces`` (MineRL 0.4.4) on the legacy gym
stand-in: ``Enum(*values, default=...)`` with ``values`` a numpy array of
strings, ``Discrete``, ``Box`` and ``Dict``, each with ``noop()``."""
import gym
import numpy as np


class Enum(gym.spaces.Discrete):
    def __init__(self, *values, default=None):
        self.values = np.array(sorted(values))
        self.default = default if default is not None else self.values[0]
        super().__init__(len(values))

    def noop(self):
        return self.default

    def sample(self):
        return self.values[self.np_random.randint(len(self.values))]


class Discrete(gym.spaces.Discrete):
    def noop(self):
        return 0


class Box(gym.spaces.Box):
    def noop(self):
        return np.zeros(self.shape, self.dtype)


class Dict(gym.spaces.Dict):
    def noop(self):
        return {k: s.noop() for k, s in self.spaces.items()}
