"""Environment construction (the part of ``sheeprl_tpu/utils/env.py`` that the
DreamerV3 loop on the dummy env needs): ``make_env``, ``vectorize``,
``get_dummy_env`` and ``episode_stats``.

The vector env, the time limit and the episode statistics are the port's own
minimal versions of gymnasium's ``SyncVectorEnv`` (same-step autoreset: the
reset observation comes back at the done step and the true final
observation in ``info["final_obs"]``), ``TimeLimit`` and
``RecordEpisodeStatistics`` (the dict-of-arrays ``final_info`` format), so
the port runs where gymnasium is not installed. Images stay NHWC. Resizing,
frame stacking, the observation wrappers, async vector envs and env restarts
are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..config import Config, instantiate
from ..envs import spaces


class _Wrapper:
    def __init__(self, env: Any):
        self.env = env

    def __getattr__(self, name: str) -> Any:
        return getattr(self.env, name)

    def reset(self, **kwargs: Any):
        return self.env.reset(**kwargs)

    def close(self) -> None:
        self.env.close()


class TimeLimit(_Wrapper):
    def __init__(self, env: Any, max_episode_steps: int):
        super().__init__(env)
        self._max, self._elapsed = int(max_episode_steps), 0

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        return obs, reward, terminated, truncated or self._elapsed >= self._max, info

    def reset(self, **kwargs: Any):
        self._elapsed = 0
        return self.env.reset(**kwargs)


class RecordEpisodeStatistics(_Wrapper):
    """Adds ``info["episode"] = {"r": return, "l": length}`` at episode end."""

    def __init__(self, env: Any):
        super().__init__(env)
        self._return, self._length = 0.0, 0

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._return += float(reward)
        self._length += 1
        if terminated or truncated:
            info = dict(info, episode={"r": self._return, "l": self._length})
        return obs, reward, terminated, truncated, info

    def reset(self, **kwargs: Any):
        self._return, self._length = 0.0, 0
        return self.env.reset(**kwargs)


class SyncVectorEnv:
    """Steps ``num_envs`` envs in this process; a finished env is reset in the
    same step."""

    def __init__(self, env_fns: List[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space

    @staticmethod
    def _stack(obs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([o[k] for o in obs]) for k in obs[0]}

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        obs = [env.reset(seed=None if seed is None else seed + i)[0] for i, env in enumerate(self.envs)]
        return self._stack(obs), {}

    def step(self, actions: Any):
        n = self.num_envs
        obs, rewards = [], np.zeros(n, np.float64)
        terminated, truncated = np.zeros(n, bool), np.zeros(n, bool)
        final_obs: List[Any] = [None] * n
        ep_r, ep_l, ep_mask = np.zeros(n, np.float64), np.zeros(n, np.int64), np.zeros(n, bool)
        for i, env in enumerate(self.envs):
            o, r, te, tr, inf = env.step(actions[i])
            rewards[i], terminated[i], truncated[i] = r, te, tr
            if te or tr:
                final_obs[i] = o
                if "episode" in inf:
                    ep_r[i], ep_l[i], ep_mask[i] = inf["episode"]["r"], inf["episode"]["l"], True
                o, _ = env.reset()
            obs.append(o)
        info: Dict[str, Any] = {}
        done = terminated | truncated
        if done.any():
            fo = np.empty(n, dtype=object)
            fo[:] = final_obs
            info["final_obs"], info["_final_obs"] = fo, done
            info["final_info"] = {"episode": {"r": ep_r, "l": ep_l, "_r": ep_mask}, "_episode": ep_mask}
        return self._stack(obs), rewards, terminated, truncated, info

    def close(self) -> None:
        for env in self.envs:
            env.close()


def make_env(cfg: Config, seed: int, rank: int, vector_env_idx: int = 0) -> Callable[[], Any]:
    def thunk() -> Any:
        wrapper_cfg = cfg.env.wrapper
        kwargs: Dict[str, Any] = {}
        if "seed" in wrapper_cfg:
            kwargs["seed"] = seed
        if "rank" in wrapper_cfg:
            kwargs["rank"] = rank + vector_env_idx
        env = instantiate(wrapper_cfg, **kwargs)
        cnn_keys = list(cfg.algo.cnn_keys.encoder or [])
        mlp_keys = list(cfg.algo.mlp_keys.encoder or [])
        if not cnn_keys + mlp_keys:
            raise ValueError(
                "`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must be lists of strings with "
                "at least one key between them"
            )
        space = env.observation_space
        if not isinstance(space, spaces.Dict):
            raise NotImplementedError(f"only dict observation spaces are ported, got {space}")
        missing = set(cnn_keys + mlp_keys) - set(space.keys())
        if missing:
            raise ValueError(f"observation keys {sorted(missing)} not in the env's {sorted(space.keys())}")
        screen = int(cfg.env.screen_size)
        for k in cnn_keys:
            if tuple(space[k].shape[:2]) != (screen, screen):
                raise NotImplementedError(
                    f"'{k}' is {space[k].shape}: resizing to env.screen_size={screen} is not ported yet"
                )
        env.action_space.seed(seed)
        env.observation_space.seed(seed)
        if cfg.env.get("max_episode_steps", None) and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, cfg.env.max_episode_steps)
        return RecordEpisodeStatistics(env)

    return thunk


def vectorize(cfg: Config, seed: int, rank: int) -> SyncVectorEnv:
    if not cfg.env.get("sync_env", True):
        raise NotImplementedError("env.sync_env=False: async vector envs are not ported yet")
    return SyncVectorEnv([make_env(cfg, seed + rank * cfg.env.num_envs + i, rank, i) for i in range(cfg.env.num_envs)])


def episode_stats(info: Dict[str, Any]):
    """Yield (reward, length) for every env that finished an episode this step."""
    fi = info.get("final_info")
    if not fi or "episode" not in fi:
        return
    ep = fi["episode"]
    mask = np.asarray(ep.get("_r", np.ones_like(np.atleast_1d(ep["r"]), dtype=bool)))
    rs, ls = np.atleast_1d(ep["r"]), np.atleast_1d(ep["l"])
    for i in range(len(rs)):
        if mask[i]:
            yield float(rs[i]), float(ls[i])


def get_dummy_env(id: str) -> Any:
    from ..envs.dummy import ContinuousDummyEnv, DiscreteDummyEnv, MultiDiscreteDummyEnv

    if "crashing" in id:
        raise NotImplementedError("the crashing dummy env needs env restarts, which are not ported yet")
    if "continuous" in id:
        return ContinuousDummyEnv()
    if "multidiscrete" in id:
        return MultiDiscreteDummyEnv()
    if "discrete" in id:
        return DiscreteDummyEnv()
    raise ValueError(f"Unrecognized dummy environment: {id}")
