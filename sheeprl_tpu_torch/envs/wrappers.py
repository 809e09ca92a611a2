"""Env wrappers (the port's own copies of ``sheeprl_tpu/envs/wrappers.py``):
``MaskVelocityWrapper``, ``ActionRepeat``, ``RestartOnException``,
``FrameStack`` (with dilation), ``RewardAsObservationWrapper``,
``ActionsAsObservationWrapper`` and ``GrayscaleRenderWrapper``, and
``RecordVideo`` (gymnasium's, on the port's wrapper). Reward
clipping (``env.clip_rewards``) is the training loop's, as in the JAX
package.

They hold the gymnasium env interface (``reset``/``step``/``render``/
``close``, ``observation_space``/``action_space``) on the port's own spaces
(``envs/spaces.py``) and import no gymnasium: the suites' adapters
(``envs/gym_env.py``, ``envs/dmc.py``) present their envs on those spaces.
Images are NHWC.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import spaces


class Wrapper:
    """Forwards everything it does not override to the wrapped env."""

    def __init__(self, env: Any):
        self.env = env

    def __getattr__(self, name: str) -> Any:
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def observation_space(self) -> Any:
        return self.__dict__.get("_observation_space", self.env.observation_space)

    @observation_space.setter
    def observation_space(self, space: Any) -> None:
        self.__dict__["_observation_space"] = space

    @property
    def action_space(self) -> Any:
        return self.env.action_space

    @property
    def unwrapped(self) -> Any:
        return self.env.unwrapped if hasattr(self.env, "unwrapped") else self.env

    def reset(self, **kwargs: Any):
        return self.env.reset(**kwargs)

    def step(self, action: Any):
        return self.env.step(action)

    def render(self):
        return self.env.render()

    def close(self) -> None:
        self.env.close()


class ObservationWrapper(Wrapper):
    def observation(self, observation: Any) -> Any:
        raise NotImplementedError

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return self.observation(obs), info

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(obs), reward, terminated, truncated, info


class MaskVelocityWrapper(ObservationWrapper):
    """Zero out the velocity entries of classic-control observations."""

    velocity_indices: Dict[str, np.ndarray] = {
        "CartPole-v0": np.array([1, 3]),
        "CartPole-v1": np.array([1, 3]),
        "MountainCar-v0": np.array([1]),
        "MountainCarContinuous-v0": np.array([1]),
        "Pendulum-v1": np.array([2]),
        "LunarLander-v2": np.array([2, 3, 5]),
        "LunarLanderContinuous-v2": np.array([2, 3, 5]),
    }

    def __init__(self, env: Any):
        super().__init__(env)
        spec = getattr(self.unwrapped, "spec", None)
        env_id = spec.id if spec is not None else ""
        if env_id not in self.velocity_indices:
            raise NotImplementedError(f"Velocity masking not implemented for {env_id}")
        self.mask = np.ones(env.observation_space.shape, dtype=np.float32)
        self.mask[self.velocity_indices[env_id]] = 0.0

    def observation(self, observation: np.ndarray) -> np.ndarray:
        return observation * self.mask


class ActionRepeat(Wrapper):
    """Repeat each action ``amount`` times, summing the rewards."""

    def __init__(self, env: Any, amount: int = 1):
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` should be a positive integer")
        self._amount = int(amount)

    @property
    def action_repeat(self) -> int:
        return self._amount

    def step(self, action: Any):
        done = truncated = False
        current_step, total_reward = 0, 0.0
        obs, info = None, {}
        while current_step < self._amount and not (done or truncated):
            obs, reward, done, truncated, info = self.env.step(action)
            total_reward += float(reward)
            current_step += 1
        return obs, total_reward, done, truncated, info


class RestartOnException(Wrapper):
    """Re-create a crashed env, with a budget of ``maxfails`` crashes in a
    sliding ``window`` of seconds. The crash step is reported either as an
    ordinary truncation (``report_truncated=True``, right for any loop) or
    as no episode end with ``info["restart_on_exception"]`` and the restarted
    env's reset observation (``report_truncated=False``), for a loop that
    rewrites its replay buffer so the crash row becomes a truncation
    boundary (``EnvIndependentReplayBuffer.mark_restart``)."""

    def __init__(self, env_fn, exceptions: Tuple = (Exception,), window: float = 300.0, maxfails: int = 2,
                 wait: float = 0.0, report_truncated: bool = True):
        self._env_fn = env_fn
        self._exceptions = tuple(exceptions) if isinstance(exceptions, (tuple, list)) else (exceptions,)
        self._window = window
        self._maxfails = maxfails
        self._wait = wait
        self._report_truncated = bool(report_truncated)
        self._fails = 0
        self._last_fail_time = 0.0
        super().__init__(env_fn())

    def _restart(self) -> None:
        now = time.time()
        self._fails = self._fails + 1 if now - self._last_fail_time < self._window else 1
        self._last_fail_time = now
        if self._fails > self._maxfails:
            raise RuntimeError(f"Env crashed too many times ({self._fails} in {self._window}s)")
        try:
            self.env.close()
        except Exception:  # noqa: BLE001 - a crashed env may fail to close too
            pass
        if self._wait:
            time.sleep(self._wait)
        self.env = self._env_fn()

    def reset(self, **kwargs: Any):
        for _ in range(self._maxfails + 1):
            try:
                return self.env.reset(**kwargs)
            except self._exceptions:
                self._restart()
                try:
                    obs, info = self.env.reset(**kwargs)
                except self._exceptions:
                    continue
                return obs, dict(info, restart_on_exception=True)
        raise RuntimeError("Unreachable")

    def step(self, action: Any):
        try:
            return self.env.step(action)
        except self._exceptions:
            self._restart()
            obs, info = self.env.reset()
            return obs, 0.0, False, self._report_truncated, dict(info, restart_on_exception=True)


class FrameStack(Wrapper):
    """Stack the last ``num_stack`` frames of every image key on the channel
    axis ([H, W, C·num_stack]), every ``dilation``-th frame, the newest
    last."""

    def __init__(self, env: Any, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1):
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"Invalid value for num_stack: {num_stack}")
        if not isinstance(env.observation_space, spaces.Dict):
            raise RuntimeError(f"FrameStack requires dict observations, got {type(env.observation_space)}")
        self._num_stack = num_stack
        self._dilation = dilation
        self._cnn_keys = [
            k for k in (cnn_keys or []) if k in env.observation_space.spaces and len(env.observation_space[k].shape) == 3
        ]
        if not self._cnn_keys:
            raise RuntimeError(f"Specify at least one valid cnn key for frame stacking: {cnn_keys}")
        self._frames: Dict[str, deque] = {k: deque(maxlen=num_stack * dilation) for k in self._cnn_keys}
        new_spaces = dict(env.observation_space.spaces)
        for k in self._cnn_keys:
            sp = env.observation_space[k]
            h, w, c = sp.shape
            new_spaces[k] = spaces.Box(np.repeat(sp.low, num_stack, axis=-1), np.repeat(sp.high, num_stack, axis=-1),
                                       (h, w, c * num_stack), sp.dtype)
        self.observation_space = spaces.Dict(new_spaces)

    def _get_obs(self, obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(obs)
        for k in self._cnn_keys:
            # the dilation-1 offset keeps the newest frame in the stack
            frames = list(self._frames[k])[self._dilation - 1 :: self._dilation][-self._num_stack :]
            out[k] = np.concatenate(frames, axis=-1)
        return out

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        for k in self._cnn_keys:
            self._frames[k].clear()
            for _ in range(self._num_stack * self._dilation):
                self._frames[k].append(obs[k])
        return self._get_obs(obs), info

    def step(self, action: Any):
        obs, reward, done, truncated, info = self.env.step(action)
        for k in self._cnn_keys:
            self._frames[k].append(obs[k])
        return self._get_obs(obs), reward, done, truncated, info


class RewardAsObservationWrapper(Wrapper):
    """The last reward under the observation key ``reward``."""

    def __init__(self, env: Any):
        super().__init__(env)
        reward_space = spaces.Box(-np.inf, np.inf, (1,), np.float32)
        if isinstance(env.observation_space, spaces.Dict):
            self.observation_space = spaces.Dict({**env.observation_space.spaces, "reward": reward_space})
        else:
            self.observation_space = spaces.Dict({"obs": env.observation_space, "reward": reward_space})

    @staticmethod
    def _wrap(obs: Any, reward: float) -> Dict[str, Any]:
        r = np.array([reward], dtype=np.float32)
        return {**obs, "reward": r} if isinstance(obs, dict) else {"obs": obs, "reward": r}

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return self._wrap(obs, 0.0), info

    def step(self, action: Any):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._wrap(obs, float(reward)), reward, done, truncated, info


class ActionsAsObservationWrapper(Wrapper):
    """The last ``num_stack`` actions (one-hot for discrete spaces), every
    ``dilation``-th one, under the observation key ``action_stack``; ``noop``
    fills the stack at reset."""

    def __init__(self, env: Any, num_stack: int, noop: Any, dilation: int = 1):
        super().__init__(env)
        if num_stack < 1:
            raise ValueError(f"The number of stacked actions must be greater than zero, got: {num_stack}")
        if dilation < 1:
            raise ValueError(f"The dilation must be greater than zero, got: {dilation}")
        self._num_stack = num_stack
        self._dilation = dilation
        act_space = env.action_space
        if isinstance(act_space, spaces.Discrete):
            if not isinstance(noop, int):
                raise ValueError(f"The noop action must be an integer for discrete action spaces, got: {noop}")
            self._per_action = int(act_space.n)
            self._noop = np.zeros(self._per_action, dtype=np.float32)
            self._noop[noop] = 1.0
        elif isinstance(act_space, spaces.MultiDiscrete):
            if not isinstance(noop, (list, tuple)):
                raise ValueError(f"The noop action must be a list for multi-discrete action spaces, got: {noop}")
            nvec = act_space.nvec
            if len(noop) != len(nvec):
                raise ValueError(f"The noop action must have {len(nvec)} entries, got: {len(noop)}")
            self._per_action = int(sum(nvec))
            self._noop = np.concatenate([np.eye(int(n), dtype=np.float32)[int(a)] for n, a in zip(nvec, noop)])
        elif isinstance(act_space, spaces.Box):
            if not isinstance(noop, float):
                raise ValueError(f"The noop action must be a float for continuous action spaces, got: {noop}")
            self._per_action = int(np.prod(act_space.shape))
            self._noop = np.full(self._per_action, noop, dtype=np.float32)
        else:
            raise RuntimeError(f"Unsupported action space for ActionsAsObservation: {type(act_space)}")
        self._actions: deque = deque(maxlen=num_stack * dilation)
        obs_spaces = (dict(env.observation_space.spaces) if isinstance(env.observation_space, spaces.Dict)
                      else {"obs": env.observation_space})
        obs_spaces["action_stack"] = spaces.Box(-np.inf, np.inf, (self._per_action * num_stack,), np.float32)
        self.observation_space = spaces.Dict(obs_spaces)

    def _action_vec(self, action: Any) -> np.ndarray:
        act_space = self.env.action_space
        if isinstance(act_space, spaces.Discrete):
            return np.eye(self._per_action, dtype=np.float32)[int(np.asarray(action).reshape(()))]
        if isinstance(act_space, spaces.MultiDiscrete):
            return np.concatenate([np.eye(int(n), dtype=np.float32)[int(a)]
                                   for n, a in zip(act_space.nvec, np.asarray(action).reshape(-1))])
        return np.asarray(action, dtype=np.float32).reshape(-1)

    def _obs(self, obs: Any) -> Dict[str, Any]:
        stacked = list(self._actions)[self._dilation - 1 :: self._dilation][-self._num_stack :]
        action_obs = np.concatenate(stacked).astype(np.float32)
        return {**obs, "action_stack": action_obs} if isinstance(obs, dict) else {"obs": obs, "action_stack": action_obs}

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        self._actions.clear()
        for _ in range(self._num_stack * self._dilation):
            self._actions.append(self._noop)
        return self._obs(obs), info

    def step(self, action: Any):
        obs, reward, done, truncated, info = self.env.step(action)
        self._actions.append(self._action_vec(action))
        return self._obs(obs), reward, done, truncated, info


class GrayscaleRenderWrapper(Wrapper):
    """``render()`` returns grayscale frames (three equal channels)."""

    def render(self):
        frame = self.env.render()
        if frame is not None and frame.ndim == 3 and frame.shape[-1] == 3:
            frame = np.repeat(np.expand_dims(frame.mean(-1).astype(frame.dtype), axis=-1), 3, axis=-1)
        return frame


def capped_cubic_video_schedule(episode_id: int) -> bool:
    """gymnasium's default video trigger: the cubes below 1000, then every
    1000th episode."""
    if episode_id < 1000:
        return int(round(episode_id ** (1.0 / 3))) ** 3 == episode_id
    return episode_id % 1000 == 0


def moviepy_writer() -> Callable[[List[np.ndarray], str, float], None]:
    """A writer of ``frames`` to an mp4 at ``path`` through moviepy's
    ``ImageSequenceClip``, as gymnasium's RecordVideo writes; raises
    ImportError where moviepy is not installed."""
    from moviepy.video.io.ImageSequenceClip import ImageSequenceClip

    def write(frames: List[np.ndarray], path: str, fps: float) -> None:
        ImageSequenceClip(frames, fps=fps).write_videofile(path, logger=None)

    return write


class RecordVideo(Wrapper):
    """The ``render()`` frames of every episode ``episode_trigger`` picks
    (gymnasium's capped cubic schedule by default) written, when the episode
    ends, as ``<video_folder>/<name_prefix>-episode-<id>.mp4`` at the env's
    ``metadata["render_fps"]`` (30 where unset). ``writer(frames, path,
    fps)`` writes one video; the default is moviepy's, and without moviepy
    the constructor raises ImportError, as gymnasium's RecordVideo raises
    that the dependency is not installed."""

    def __init__(self, env: Any, video_folder: str, episode_trigger: Optional[Callable[[int], bool]] = None,
                 name_prefix: str = "rl-video", writer: Optional[Callable[..., None]] = None):
        super().__init__(env)
        self._writer = writer if writer is not None else moviepy_writer()
        self.video_folder = os.path.abspath(video_folder)
        os.makedirs(self.video_folder, exist_ok=True)
        self.episode_trigger = episode_trigger or capped_cubic_video_schedule
        self.name_prefix = name_prefix
        self.episode_id = -1
        self._frames: List[np.ndarray] = []
        self._recording = False

    def _capture(self) -> None:
        frame = self.env.render()
        if frame is not None:
            self._frames.append(np.asarray(frame))

    def _flush(self) -> None:
        if self._frames:
            fps = (getattr(self.env, "metadata", None) or {}).get("render_fps", 30)
            path = os.path.join(self.video_folder, f"{self.name_prefix}-episode-{self.episode_id}.mp4")
            self._writer(self._frames, path, fps)
        self._frames = []
        self._recording = False

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        self._flush()
        self.episode_id += 1
        self._recording = self.episode_trigger(self.episode_id)
        if self._recording:
            self._capture()
        return obs, info

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        if self._recording:
            self._capture()
            if terminated or truncated:
                self._flush()
        return obs, reward, terminated, truncated, info

    def close(self) -> None:
        self._flush()
        super().close()
