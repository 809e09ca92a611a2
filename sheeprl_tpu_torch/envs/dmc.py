"""The DeepMind Control Suite adapter (the port's own copy of
``sheeprl_tpu/envs/dmc.py``): actions in [-1, 1] rescaled to the task's
bounds; a dict observation of ``rgb`` (rendered pixels, NHWC unless
``channels_first``) and/or ``state`` (the flattened vector observation);
``truncated`` when the time limit fires with discount 1, ``terminated`` when
the discount is 0. The env is on the port's own spaces.

An EGL context stays bound to the thread that made it current, and the
training loop resets its envs on one thread and steps them on another (the
overlap engine's player): every GL call of an env (rendering, closing) runs
on one thread of its own.

dm_control is imported here only, and only when an env is made.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import spaces


def _spec_to_box(spec, dtype) -> spaces.Box:
    """One Box over a list of dm_env specs: bounded specs broadcast their
    bounds over their elements, plain arrays are unbounded."""
    from dm_env import specs

    def bounds(s):
        if s.dtype not in (np.float32, np.float64):
            raise AssertionError(f"non-float dm_env spec: {s}")
        n = int(np.prod(s.shape))
        if isinstance(s, specs.BoundedArray):
            return (np.broadcast_to(np.asarray(s.minimum, np.float32), (n,)),
                    np.broadcast_to(np.asarray(s.maximum, np.float32), (n,)))
        if isinstance(s, specs.Array):
            hi = np.full((n,), np.inf, np.float32)
            return -hi, hi
        raise ValueError(f"Unrecognized spec: {type(s)}")

    lows, highs = (np.concatenate(part).astype(dtype) for part in zip(*map(bounds, spec)))
    return spaces.Box(lows, highs, lows.shape, dtype)


def _flatten_obs(obs: Dict[Any, Any]) -> np.ndarray:
    return np.concatenate([np.ravel(v) for v in obs.values()])


class DMCWrapper:
    """A dm_control task with the gymnasium env interface."""

    def __init__(
        self,
        domain_name: str,
        task_name: str,
        from_pixels: bool = False,
        from_vectors: bool = True,
        height: int = 84,
        width: int = 84,
        camera_id: int = 0,
        task_kwargs: Optional[Dict[Any, Any]] = None,
        environment_kwargs: Optional[Dict[Any, Any]] = None,
        channels_first: bool = False,
        visualize_reward: bool = False,
        seed: Optional[int] = None,
    ):
        from dm_control import suite

        if not (from_vectors or from_pixels):
            raise ValueError(
                "'from_vectors' and 'from_pixels' must not be both False: "
                f"got {from_vectors} and {from_pixels} respectively."
            )
        self._from_pixels = from_pixels
        self._from_vectors = from_vectors
        self._height = height
        self._width = width
        self._camera_id = camera_id
        self._channels_first = channels_first
        task_kwargs = dict(task_kwargs or {})
        # the constructor's seed seeds the task's dynamics
        task_kwargs.pop("random", None)
        if seed is not None:
            task_kwargs["random"] = seed
        self._gl = ThreadPoolExecutor(max_workers=1, thread_name_prefix="dmc-render")
        self._closed = False
        self.env = suite.load(domain_name=domain_name, task_name=task_name, task_kwargs=task_kwargs,
                              visualize_reward=visualize_reward, environment_kwargs=environment_kwargs)
        self._true_action_space = _spec_to_box([self.env.action_spec()], np.float32)
        self._norm_action_space = spaces.Box(-1.0, 1.0, self._true_action_space.shape, np.float32)
        reward_space = _spec_to_box([self.env.reward_spec()], np.float32)
        self._reward_range = (reward_space.low.item(), reward_space.high.item())
        obs_space: Dict[str, spaces.Space] = {}
        if from_pixels:
            shape = (3, height, width) if channels_first else (height, width, 3)
            obs_space["rgb"] = spaces.Box(0, 255, shape, np.uint8)
        if from_vectors:
            obs_space["state"] = _spec_to_box(self.env.observation_spec().values(), np.float64)
        self.observation_space = spaces.Dict(obs_space)
        self.state_space = _spec_to_box(self.env.observation_spec().values(), np.float64)
        self.current_state = None
        self.render_mode = "rgb_array"
        self.metadata = {"render_fps": 30}
        self.seed(seed=seed)

    @property
    def action_space(self) -> spaces.Box:
        return self._norm_action_space

    @property
    def reward_range(self) -> Tuple[float, float]:
        return self._reward_range

    @property
    def unwrapped(self) -> "DMCWrapper":
        return self

    def seed(self, seed: Optional[int] = None) -> None:
        self._true_action_space.seed(seed)
        self._norm_action_space.seed(seed)
        self.observation_space.seed(seed)

    def _get_obs(self, time_step) -> Dict[str, np.ndarray]:
        obs: Dict[str, np.ndarray] = {}
        if self._from_pixels:
            rgb = self.render(camera_id=self._camera_id)
            obs["rgb"] = rgb.transpose(2, 0, 1).copy() if self._channels_first else rgb
        if self._from_vectors:
            obs["state"] = _flatten_obs(time_step.observation)
        return obs

    def _convert_action(self, action) -> np.ndarray:
        action = np.asarray(action, np.float64)
        true_delta = self._true_action_space.high - self._true_action_space.low
        norm_delta = self._norm_action_space.high - self._norm_action_space.low
        action = (action - self._norm_action_space.low) / norm_delta
        return (action * true_delta + self._true_action_space.low).astype(np.float32)

    def step(self, action):
        time_step = self.env.step(self._convert_action(action))
        reward = time_step.reward or 0.0
        obs = self._get_obs(time_step)
        self.current_state = _flatten_obs(time_step.observation)
        extra = {"discount": time_step.discount, "internal_state": self.env.physics.get_state().copy()}
        truncated = time_step.last() and time_step.discount == 1
        terminated = False if time_step.first() else bool(time_step.last() and time_step.discount == 0)
        return obs, reward, terminated, truncated, extra

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        if seed is not None:
            try:
                self.env.task._random = np.random.RandomState(seed)
            except AttributeError:
                pass
        time_step = self.env.reset()
        self.current_state = _flatten_obs(time_step.observation)
        return self._get_obs(time_step), {}

    def render(self, camera_id: Optional[int] = None):
        return self._gl.submit(self.env.physics.render, height=self._height, width=self._width,
                               camera_id=camera_id or self._camera_id).result()

    def close(self) -> None:
        """Free the physics and its GL contexts, on the thread that holds
        them."""
        if not self._closed:
            self._closed = True
            self._gl.submit(self.env.physics.free).result()
            self._gl.shutdown()
