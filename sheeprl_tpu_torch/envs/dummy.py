"""Deterministic dummy envs — the test fake backend.

The port's own copy of ``sheeprl_tpu/envs/dummy.py``: dict observations
{rgb, state} with deterministic step-counter content and fixed-length
episodes; images NHWC. They implement the gymnasium env interface
(``reset``/``step``/``close``, ``observation_space``/``action_space``) on the
port's own spaces, so they need no gymnasium.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from . import spaces


class BaseDummyEnv:
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (64, 64, 3),
        n_steps: int = 128,
        vector_shape: Tuple[int, ...] = (10,),
    ):
        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, shape=image_size, dtype=np.uint8),
                "state": spaces.Box(-20, 20, shape=vector_shape, dtype=np.float32),
            }
        )
        self._current_step = 0
        self._n_steps = n_steps

    def get_obs(self) -> Any:
        return {
            "rgb": np.full(self.observation_space["rgb"].shape, self._current_step % 256, dtype=np.uint8),
            "state": np.full(self.observation_space["state"].shape, self._current_step, dtype=np.float32),
        }

    def step(self, action: Any):
        done = self._current_step == self._n_steps
        self._current_step += 1
        return self.get_obs(), 0.0, done, False, {}

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        self._current_step = 0
        return self.get_obs(), {}

    def render(self):
        """The current ``rgb`` observation (a video recorder's frame)."""
        return self.get_obs()["rgb"]

    def close(self):
        pass


class ContinuousDummyEnv(BaseDummyEnv):
    def __init__(self, action_dim: int = 2, **kwargs: Any):
        self.action_space = spaces.Box(-1.0, 1.0, shape=(action_dim,), dtype=np.float32)
        super().__init__(**kwargs)


class DiscreteDummyEnv(BaseDummyEnv):
    def __init__(self, action_dim: int = 2, n_steps: int = 4, **kwargs: Any):
        self.action_space = spaces.Discrete(action_dim)
        super().__init__(n_steps=n_steps, **kwargs)


class MultiDiscreteDummyEnv(BaseDummyEnv):
    def __init__(self, action_dims: Optional[List[int]] = None, **kwargs: Any):
        self.action_space = spaces.MultiDiscrete(action_dims or [2, 2])
        super().__init__(**kwargs)


class CrashingDummyEnv(DiscreteDummyEnv):
    """A discrete dummy that raises every ``crash_every`` steps of its
    lifetime: drives env restarts (``RestartOnException``) and the buffer's
    restart surgery."""

    def __init__(self, crash_every: int = 3, **kwargs: Any):
        super().__init__(**kwargs)
        self._crash_every = int(crash_every)
        self._lifetime_steps = 0

    def step(self, action: Any):
        self._lifetime_steps += 1
        if self._lifetime_steps % self._crash_every == 0:
            raise RuntimeError(f"scripted crash at lifetime step {self._lifetime_steps}")
        return super().step(action)
