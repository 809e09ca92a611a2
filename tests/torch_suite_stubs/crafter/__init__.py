"""Stand-in for crafter 1.8.3 (``crafter.Env``).

Mirrors: ``Env(area, view, size, reward, length, seed)``; its spaces from
the legacy ``gym`` where it imports (``gym.spaces.Box(0, 255, size + (3,),
uint8)``, ``Discrete(17)``, ``gym.Env`` as the base, so ``reward_range``)
and otherwise namedtuples (``BoxSpace(low, high, shape, dtype)``,
``DiscreteSpace(n)``) on ``object``, as crafter does; ``reset()`` returns
the frame and regenerates the world from ``_seed`` and the episode
number; ``step(action)`` returns ``(frame, reward, done, info)`` with
``info["discount"]`` 0 where the player died and 1 otherwise (also at the
time limit, ``length`` steps), reward the health change / 10 plus one per
achievement unlocked (0 with ``reward=False``); ``render()`` the frame;
no ``close()``.

The world is not crafter's: a deterministic toy (the frame a function of
the seed, episode, position and step; damage and achievements drawn from
a generator seeded by the seed and episode) whose player dies within a few
dozen steps. ``length=None`` takes the module's ``LENGTH`` (crafter's
default, 10000), which a test may lower.
"""
import collections

import numpy as np

try:
    import gym

    DiscreteSpace = gym.spaces.Discrete
    BoxSpace = gym.spaces.Box
    BaseClass = gym.Env
except ImportError:
    DiscreteSpace = collections.namedtuple("DiscreteSpace", "n")
    BoxSpace = collections.namedtuple("BoxSpace", "low, high, shape, dtype")
    BaseClass = object

__version__ = "1.8.3-stand-in"
LENGTH = 10000
ACTIONS = ("noop", "move_left", "move_right", "move_up", "move_down", "do", "sleep", "place_stone",
           "place_table", "place_furnace", "place_plant", "make_wood_pickaxe", "make_stone_pickaxe",
           "make_iron_pickaxe", "make_wood_sword", "make_stone_sword", "make_iron_sword")
_MOVES = {1: (0, -1), 2: (0, 1), 3: (-1, 0), 4: (1, 0)}


class Env(BaseClass):
    def __init__(self, area=(64, 64), view=(9, 9), size=(64, 64), reward=True, length=None, seed=None):
        self._area = tuple(area)
        self._size = tuple(size)
        self._reward = reward
        self._length = LENGTH if length is None else length
        self._seed = np.random.randint(0, 2 ** 31 - 1) if seed is None else seed
        self._episode = 0
        self._step = None
        self._frame = None

    @property
    def observation_space(self):
        return BoxSpace(0, 255, tuple(self._size) + (3,), np.uint8)

    @property
    def action_space(self):
        return DiscreteSpace(len(ACTIONS))

    @property
    def action_names(self):
        return ACTIONS

    def reset(self):
        self._episode += 1
        self._step = 0
        self._rng = np.random.default_rng([int(self._seed) % (2 ** 31 - 1), self._episode])
        self._tiles = self._rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        self._pos = np.array(self._area) // 2
        self._health = 9
        self._unlocked = set()
        return self._obs()

    def _obs(self):
        h, w = self._size
        reps = (-(-h // 8), -(-w // 8), 1)
        frame = np.tile(self._tiles, reps)[:h, :w].copy()
        y, x = (self._pos * np.array([h, w]) // np.array(self._area)) % np.array([h, w])
        frame[y : y + 4, x : x + 4] = (255, 255 - 16 * self._health, (self._step * 7) % 256)
        frame[-2:, : 2 * len(self._unlocked)] = 0
        self._frame = frame
        return frame

    def step(self, action):
        action = int(action)
        self._step += 1
        if action in _MOVES:
            self._pos = np.clip(self._pos + np.array(_MOVES[action]), 0, np.array(self._area) - 1)
        before = self._health
        self._health -= int(self._rng.random() < 0.3)
        if action == 6:  # sleeping heals
            self._health = min(9, self._health + 1)
        unlocked = 0
        if action >= 5 and self._rng.random() < 0.25 and action not in self._unlocked:
            self._unlocked.add(action)
            unlocked = 1
        reward = (self._health - before) / 10 + unlocked
        dead = self._health <= 0
        over = self._length and self._step >= self._length
        done = dead or over
        info = {"inventory": {"health": self._health}, "achievements": {ACTIONS[a]: 1 for a in self._unlocked},
                "discount": 1 - float(dead), "player_pos": self._pos.copy(), "reward": reward}
        if not self._reward:
            reward = 0.0
        return self._obs(), reward, done, info

    def render(self, size=None):
        return self._frame
