"""Stand-in for the legacy ``gym`` package (0.19-0.21, the API that
crafter 1.8.3, nes_py 8.2 and MineRL 0.4.4 build on).

Mirrors: ``gym.Env`` (``reward_range``, ``metadata``, ``unwrapped``),
``gym.Wrapper`` (forwarding), ``gym.spaces.{Box, Discrete, Dict}`` and
``gym.make``/``gym.register`` over an in-process registry (``entry_point``
a callable, ``max_episode_steps`` adds ``info["TimeLimit.truncated"]`` as
gym's TimeLimit does). 4-tuple steps; ``reset()`` returns the observation.
"""
from typing import Any, Callable, Dict, Optional

from . import spaces

__version__ = "0.21.0-stand-in"


class Env:
    reward_range = (-float("inf"), float("inf"))
    metadata: Dict[str, Any] = {"render.modes": []}
    observation_space = None
    action_space = None

    @property
    def unwrapped(self) -> "Env":
        return self

    def close(self) -> None:
        return None


class Wrapper(Env):
    def __init__(self, env: Env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def __getattr__(self, name: str):
        if name.startswith("_") or name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    def step(self, action):
        return self.env.step(action)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def render(self, mode: str = "human", **kwargs):
        return self.env.render(mode, **kwargs)

    def close(self) -> None:
        return self.env.close()


class TimeLimit(Wrapper):
    def __init__(self, env: Env, max_episode_steps: int):
        super().__init__(env)
        self._max, self._elapsed = int(max_episode_steps), 0

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self._elapsed += 1
        if self._elapsed >= self._max:
            info["TimeLimit.truncated"] = not done
            done = True
        return obs, reward, done, info

    def reset(self, **kwargs):
        self._elapsed = 0
        return self.env.reset(**kwargs)


_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register(id: str, entry_point: Callable[..., Env], max_episode_steps: Optional[int] = None,
             kwargs: Optional[Dict[str, Any]] = None) -> None:
    _REGISTRY[id] = {"entry_point": entry_point, "max_episode_steps": max_episode_steps, "kwargs": kwargs or {}}


def make(id: str, **kwargs) -> Env:
    if id not in _REGISTRY:
        raise KeyError(f"No registered env with id: {id}")
    spec = _REGISTRY[id]
    env = spec["entry_point"](**{**spec["kwargs"], **kwargs})
    if spec["max_episode_steps"]:
        env = TimeLimit(env, spec["max_episode_steps"])
    return env
