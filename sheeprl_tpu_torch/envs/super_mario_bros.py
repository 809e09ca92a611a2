"""The Super Mario Bros adapter (the port's own copy of
``sheeprl_tpu/envs/super_mario_bros.py``).

nes_py's ``JoypadSpace`` over one of three discrete action tables
(``right_only``, ``simple``, ``complex``); a dict ``rgb`` observation;
nes_py's single ``done`` split on the game clock: a done with the clock at
zero is terminated, one with time left a truncation. The env is on the
port's own spaces.

gym_super_mario_bros and nes_py are imported when an adapter is built:
``_SeedlessJoypad`` subclasses nes_py's ``JoypadSpace``, so it is made at
first use (``joypad_class``). Without the suite the constructor raises the
JAX package's ``ModuleNotFoundError``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np

from ..utils import imports
from . import spaces
from .legacy import LegacyEnvAdapter, box_like

ACTION_SETS = {"right_only": "RIGHT_ONLY", "simple": "SIMPLE_MOVEMENT", "complex": "COMPLEX_MOVEMENT"}


@functools.lru_cache(maxsize=None)
def joypad_class() -> type:
    """``_SeedlessJoypad``: nes_py's ``JoypadSpace``, whose ``reset``
    rejects arguments, with the seed and options routed to the core."""
    imports.require(imports._IS_SUPER_MARIO_BROS_AVAILABLE)
    from nes_py.wrappers import JoypadSpace

    class _SeedlessJoypad(JoypadSpace):
        def reset(self, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
            return self.env.reset(seed=seed, options=options)

    return _SeedlessJoypad


def action_table(action_space: str) -> list:
    """The gym_super_mario_bros button lists of ``right_only``, ``simple``
    or ``complex``."""
    from gym_super_mario_bros import actions

    return getattr(actions, ACTION_SETS[action_space])


class SuperMarioBrosWrapper(LegacyEnvAdapter):
    def __init__(self, id: str, action_space: str = "simple", render_mode: str = "rgb_array"):
        joypad_cls = joypad_class()
        import gym_super_mario_bros

        joypad = joypad_cls(gym_super_mario_bros.make(id), action_table(action_space))
        super().__init__(joypad, render_mode=render_mode)
        self.observation_space = box_like(joypad.observation_space)
        self.action_space = spaces.Discrete(joypad.action_space.n)

    def step(self, action):
        if isinstance(action, np.ndarray):
            action = action.squeeze().item()
        frame, reward, done, info = self.env.step(action)
        clock_ran_out = not info.get("time", False)
        terminated = bool(done) and clock_ran_out
        return self._dict_obs(frame.copy()), reward, terminated, bool(done) and not terminated, info

    def render(self):
        frame = self.env.render(mode=self.render_mode)
        if self.render_mode == "rgb_array" and frame is not None:
            return frame.copy()
        return None

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        return self._dict_obs(self.env.reset(seed=seed, options=options).copy()), {}
