"""The Crafter adapter (the port's own copy of ``sheeprl_tpu/envs/crafter.py``).

A dict ``rgb`` observation; crafter's single ``done`` is split on
``info["discount"]``: 0 means the agent died (terminated), anything else is
the time limit (truncated). The env is on the port's own spaces.

crafter is imported when an adapter is built, never when this module is:
without it the constructor raises the JAX package's ``ModuleNotFoundError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from ..utils import imports
from . import spaces
from .legacy import LegacyEnvAdapter, box_like

_VALID_IDS = ("crafter_reward", "crafter_nonreward")


class CrafterWrapper(LegacyEnvAdapter):
    metadata = {"render_fps": 30}

    def __init__(self, id: str, screen_size: Union[Tuple[int, int], int], seed: Optional[int] = None) -> None:
        imports.require(imports._IS_CRAFTER_AVAILABLE)
        import crafter

        if id not in _VALID_IDS:
            raise AssertionError(f"id must be one of {_VALID_IDS}, got {id!r}")
        size = (screen_size, screen_size) if isinstance(screen_size, int) else tuple(screen_size)
        super().__init__(crafter.Env(size=size, seed=seed, reward=id.endswith("_reward")))
        self.observation_space = box_like(self.env.observation_space)
        self.action_space = spaces.Discrete(self.env.action_space.n)
        self.reward_range = getattr(self.env, "reward_range", None) or (-np.inf, np.inf)
        for sp in (self.observation_space, self.action_space):
            sp.seed(seed)

    def step(self, action: Any):
        frame, reward, done, info = self.env.step(action)
        died = bool(done) and info["discount"] == 0
        return self._dict_obs(frame), reward, died, bool(done) and not died, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        # crafter regenerates its world from `_seed` on reset; the reference
        # overwrites it unconditionally, which wipes the constructor's seed on
        # every autoreset and makes all vector envs replay the same worlds:
        # set it only where the caller gives one (the JAX package's departure)
        if seed is not None:
            self.env._seed = seed
        return self._dict_obs(self.env.reset()), {}

    def close(self) -> None:  # crafter.Env has no close()
        return
