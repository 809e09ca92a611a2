"""Stand-in for gym-super-mario-bros 7.4.0.

Mirrors: ``make(id)`` (``gym.make`` over the registered ids
``SuperMarioBros-v0`` .. ``-v3`` and ``SuperMarioBros-<world>-<stage>-v0``),
``actions`` (``RIGHT_ONLY``, ``SIMPLE_MOVEMENT``, ``COMPLEX_MOVEMENT``) and
``SuperMarioBrosEnv`` on nes_py's ``NESEnv``: a controller byte per step,
``info`` with ``coins``, ``flag_get``, ``life``, ``score``, ``stage``,
``status``, ``time`` (the game clock), ``world``, ``x_pos`` and ``y_pos``,
reward the x progress plus the clock penalty plus -15 at a death, clipped
to [-15, 15].

The game is not Super Mario Bros: a deterministic toy (pits drawn from the
reset seed, ``CLOCK`` ticks of game clock, one tick a step) in which Mario
dies in a pit he does not jump (A) over, and the episode ends at a death
or when the clock reaches 0. Without a seed the emulation starts from seed
0, as the NES is deterministic.
"""
import gym
import numpy as np
from nes_py import NESEnv

from . import actions

__version__ = "7.4.0-stand-in"
CLOCK = 400
_RIGHT, _LEFT, _A, _B = 0b10000000, 0b01000000, 0b00000001, 0b00000010


class SuperMarioBrosEnv(NESEnv):
    def __init__(self, rom_mode="vanilla", lost_levels=False, target=None):
        self._target = target
        self._seed = 0
        self.screen = np.zeros(self.observation_space.shape, np.uint8)

    def reset(self, seed=None, options=None, return_info=None):
        if seed is not None:
            self._seed = int(seed)
        rng = np.random.default_rng(self._seed)
        self._pits = set(int(p) for p in rng.choice(np.arange(12, 400), 40, replace=False))
        self._backdrop = rng.integers(0, 256, (16, 3), dtype=np.uint8)
        self._x, self._time, self._life, self._coins, self._score = 40, CLOCK, 2, 0, 0
        self._render()
        return self.screen

    def _render(self):
        cols = (np.arange(256) + self._x) // 16 % 16
        self.screen = np.broadcast_to(self._backdrop[cols][None], self.observation_space.shape).copy()
        self.screen[200:216, 120:132] = (228, 92, 16)
        self.screen[8:16, : min(256, self._time // 2)] = 255

    def step(self, action):
        action = int(action)
        x0 = self._x
        speed = 2 if action & _B else 1
        if action & _RIGHT:
            self._x += speed
        elif action & _LEFT:
            self._x = max(0, self._x - speed)
        self._time -= 1
        died = self._x // 4 in self._pits and not action & _A
        if action & _A and self._x // 4 in self._pits:
            self._coins += 1
            self._score += 100
        if died:
            self._life -= 1
        done = died or self._time <= 0
        reward = (self._x - x0) - 1 * (self._time < CLOCK) - 15 * died
        reward = float(np.clip(reward, -15, 15))
        self._render()
        info = {"coins": self._coins, "flag_get": False, "life": self._life, "score": self._score, "stage": 1,
                "status": "small", "time": max(0, self._time), "world": 1, "x_pos": self._x, "y_pos": 79}
        return self.screen, reward, done, info


for _version in range(4):
    gym.register(f"SuperMarioBros-v{_version}", SuperMarioBrosEnv)
for _world in range(1, 9):
    for _stage in range(1, 5):
        gym.register(f"SuperMarioBros-{_world}-{_stage}-v0",
                     lambda w=_world, s=_stage: SuperMarioBrosEnv(target=(w, s)))

make = gym.make
