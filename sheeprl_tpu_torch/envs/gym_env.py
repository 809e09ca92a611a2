"""The gymnasium adapter: ``make_gym_env`` is ``gym.make`` (the JAX package's
``sheeprl_tpu/envs/gym_env.py``) with the env presented on the port's own
spaces (``envs/spaces.py``), so the port's wrappers and loop take it.

gymnasium is imported here only, and only when an env is made: importing the
port, or running it on the dummy env, needs no gymnasium.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from . import spaces
from .wrappers import Wrapper


def from_gym_space(space: Any) -> spaces.Space:
    """The port's space for a gymnasium space (Box, Discrete, MultiDiscrete,
    Dict)."""
    import gymnasium as gym

    if isinstance(space, gym.spaces.Box):
        return spaces.Box(space.low, space.high, space.shape, space.dtype)
    if isinstance(space, gym.spaces.Discrete):
        if int(space.start) != 0:
            raise NotImplementedError(f"Discrete spaces that start at {space.start} are not taken: {space}")
        return spaces.Discrete(int(space.n))
    if isinstance(space, gym.spaces.MultiDiscrete):
        return spaces.MultiDiscrete(np.asarray(space.nvec))
    if isinstance(space, gym.spaces.Dict):
        return spaces.Dict({k: from_gym_space(v) for k, v in space.spaces.items()})
    raise NotImplementedError(f"gymnasium space {space} has no counterpart in the port")


class GymEnv(Wrapper):
    """A gymnasium env on the port's spaces (everything else forwarded)."""

    def __init__(self, env: Any):
        super().__init__(env)
        self.observation_space = from_gym_space(env.observation_space)
        self._action_space = from_gym_space(env.action_space)

    @property
    def action_space(self) -> spaces.Space:
        return self._action_space


def make_gym_env(id: str, render_mode: Optional[str] = "rgb_array", **kwargs: Any) -> GymEnv:
    import gymnasium as gym

    try:
        env = gym.make(id, render_mode=render_mode, **kwargs)
    except Exception:  # noqa: BLE001 - some envs take no render_mode
        env = gym.make(id, **kwargs)
    return GymEnv(env)
