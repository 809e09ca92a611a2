"""Environment construction (the port's own copy of ``sheeprl_tpu/utils/env.py``):
``make_env``, ``vectorize``, ``single_env``, ``patch_restarted_envs``,
``episode_stats`` and ``get_dummy_env``.

``make_env`` builds the JAX package's pipeline: ``env.wrapper`` →
ActionRepeat (not for DIAMBRA, whose engine repeats) → MaskVelocity → dict
observations (a vector-only env rendered to pixels or lifted into a one-key
dict) → resize to ``env.screen_size`` and grayscale → FrameStack →
ActionsAsObservation → RewardAsObservation → seeding → TimeLimit →
RecordEpisodeStatistics → RecordVideo (``env.capture_video`` on rank 0's
first env of a run with a log dir; where no video writer imports, a warning
and the run goes on, as in the JAX package). Images stay NHWC.

The vector envs, the time limit and the episode statistics are the port's
own versions of gymnasium's ``SyncVectorEnv``/``AsyncVectorEnv`` (same-step
autoreset: the reset observation comes back at the done step and the true
final observation in ``info["final_obs"]``), ``TimeLimit`` and
``RecordEpisodeStatistics`` (the dict-of-arrays ``final_info`` format), so
the port runs where gymnasium is not installed: gymnasium is imported by the
gym adapter (``envs/gym_env.py``) only, and cv2 only where an image is
resized or turned gray.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import warnings
from functools import partial
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..config import Config, instantiate
from ..envs import spaces
from ..envs.wrappers import (
    ActionRepeat,
    ActionsAsObservationWrapper,
    FrameStack,
    GrayscaleRenderWrapper,
    MaskVelocityWrapper,
    ObservationWrapper,
    RecordVideo,
    RestartOnException,
    RewardAsObservationWrapper,
    Wrapper,
)


class TimeLimit(Wrapper):
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


class RecordEpisodeStatistics(Wrapper):
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


class _DictObs(ObservationWrapper):
    """A Box observation as a one-key dict observation."""

    def __init__(self, env: Any, key: str):
        super().__init__(env)
        self._key = key
        self.observation_space = spaces.Dict({key: env.observation_space})

    def observation(self, observation: Any) -> Dict[str, Any]:
        return {self._key: observation}


class _RenderObs(Wrapper):
    """Rendered pixels under ``pixel_key`` (and the vector state under
    ``state_key``) for an env whose observation is a vector."""

    def __init__(self, env: Any, pixel_key: str, state_key: Optional[str]):
        super().__init__(env)
        self._pixel_key = pixel_key
        self._state_key = state_key
        env.reset()  # an env renders only after a reset (gymnasium's order enforcing, CartPole's state)
        frame = self._render_frame()
        obs_spaces: Dict[str, spaces.Space] = {pixel_key: spaces.Box(0, 255, frame.shape, np.uint8)}
        if state_key is not None:
            obs_spaces[state_key] = env.observation_space
        self.observation_space = spaces.Dict(obs_spaces)

    def _render_frame(self) -> np.ndarray:
        frame = self.env.render()
        if frame is None:
            raise RuntimeError("Pixel observations requested but the env does not render rgb_array frames")
        return np.asarray(frame, dtype=np.uint8)

    def _obs(self, obs: Any) -> Dict[str, Any]:
        out = {self._pixel_key: self._render_frame()}
        if self._state_key is not None:
            out[self._state_key] = obs
        return out

    def reset(self, **kwargs: Any):
        obs, info = self.env.reset(**kwargs)
        return self._obs(obs), info

    def step(self, action: Any):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._obs(obs), reward, done, truncated, info


class _ImageTransform(ObservationWrapper):
    """Every image key resized to ``screen_size`` (``cv2.INTER_AREA``), made
    gray or three-channel, HWC. cv2 is imported at the first image that
    needs it."""

    def __init__(self, env: Any, cnn_keys, screen_size: int, grayscale: bool):
        super().__init__(env)
        self._cnn_keys = list(cnn_keys)
        self._screen = int(screen_size)
        self._gray = bool(grayscale)
        obs_spaces = dict(env.observation_space.spaces)
        for k in self._cnn_keys:
            obs_spaces[k] = spaces.Box(0, 255, (self._screen, self._screen, 1 if self._gray else 3), np.uint8)
        self.observation_space = spaces.Dict(obs_spaces)

    def observation(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        for k in self._cnn_keys:
            img = np.asarray(obs[k])
            if img.ndim == 2:
                img = img[..., None]
            if img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):  # CHW from a suite adapter
                img = np.transpose(img, (1, 2, 0))
            if img.shape[:2] != (self._screen, self._screen):
                import cv2

                img = cv2.resize(img, (self._screen, self._screen), interpolation=cv2.INTER_AREA)
                if img.ndim == 2:
                    img = img[..., None]
            if self._gray and img.shape[-1] == 3:
                import cv2

                img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)[..., None]
            elif not self._gray and img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            obs[k] = img.astype(np.uint8)
        return obs


class _EnvFactory:
    """Builds one env of the pipeline; picklable, so an env worker process
    can build its own."""

    def __init__(self, cfg: Config, seed: int, rank: int, vector_env_idx: int, run_name: Optional[str] = None,
                 prefix: str = ""):
        self.cfg, self.seed, self.rank, self.vector_env_idx = cfg, seed, rank, vector_env_idx
        self.run_name, self.prefix = run_name, prefix

    def __call__(self) -> Any:
        cfg, seed, rank, vector_env_idx = self.cfg, self.seed, self.rank, self.vector_env_idx
        wrapper_cfg = cfg.env.wrapper
        kwargs: Dict[str, Any] = {}
        if "seed" in wrapper_cfg:
            kwargs["seed"] = seed
        if "rank" in wrapper_cfg:
            kwargs["rank"] = rank + vector_env_idx
        env = instantiate(wrapper_cfg, **kwargs)
        # DIAMBRA repeats in its engine (the wrapper's repeat_action): not twice
        if cfg.env.get("action_repeat", 1) > 1 and "diambra" not in str(wrapper_cfg.get("_target_", "")).lower():
            env = ActionRepeat(env, cfg.env.action_repeat)
        if cfg.env.get("mask_velocities", False):
            env = MaskVelocityWrapper(env)

        cnn_enc = list(cfg.algo.cnn_keys.encoder or [])
        mlp_enc = list(cfg.algo.mlp_keys.encoder or [])
        if not cnn_enc + mlp_enc:
            raise ValueError(
                "`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must be lists of strings with at least one "
                "key between them"
            )
        space = env.observation_space
        if isinstance(space, spaces.Box) and len(space.shape) < 2:
            if cnn_enc:
                if len(cnn_enc) > 1:
                    warnings.warn(f"Only the first cnn key is kept: {cnn_enc[0]}")
                env = _RenderObs(env, cnn_enc[0], mlp_enc[0] if mlp_enc else None)
            else:
                if len(mlp_enc) > 1:
                    warnings.warn(f"Only the first mlp key is kept: {mlp_enc[0]}")
                env = _DictObs(env, mlp_enc[0])
        elif isinstance(space, spaces.Box) and 2 <= len(space.shape) <= 3:
            if not cnn_enc:
                raise ValueError("Pixel-only environment but no cnn key specified: set `algo.cnn_keys.encoder`")
            if len(cnn_enc) > 1:
                warnings.warn(f"Only the first cnn key is kept: {cnn_enc[0]}")
            env = _DictObs(env, cnn_enc[0])
        if not isinstance(env.observation_space, spaces.Dict):
            raise RuntimeError(f"Unsupported observation space {env.observation_space}")
        requested, available = set(cnn_enc + mlp_enc), set(env.observation_space.keys())
        if not requested & available:
            raise ValueError(
                f"The user-specified keys {sorted(requested)} are not a subset of the environment observation "
                f"keys {sorted(available)}"
            )
        env_cnn_keys = {k for k in env.observation_space.keys() if len(env.observation_space[k].shape) in (2, 3)}
        cnn_keys = sorted(env_cnn_keys & set(cnn_enc))
        if cnn_keys:
            env = _ImageTransform(env, cnn_keys, cfg.env.screen_size, cfg.env.get("grayscale", False))
            if cfg.env.get("frame_stack", 1) > 1:
                if cfg.env.get("frame_stack_dilation", 1) <= 0:
                    raise ValueError(f"frame_stack_dilation must be > 0, got {cfg.env.frame_stack_dilation}")
                env = FrameStack(env, cfg.env.frame_stack, cnn_keys, cfg.env.frame_stack_dilation)

        actions_as_obs = cfg.env.get("actions_as_observation", None)
        if actions_as_obs and actions_as_obs.get("num_stack", 0) > 0:
            env = ActionsAsObservationWrapper(env, num_stack=actions_as_obs.num_stack, noop=actions_as_obs.noop,
                                              dilation=actions_as_obs.get("dilation", 1))
        if cfg.env.get("reward_as_observation", False):
            env = RewardAsObservationWrapper(env)
        env.action_space.seed(seed)
        env.observation_space.seed(seed)
        if cfg.env.get("max_episode_steps", None) and cfg.env.max_episode_steps > 0:
            env = TimeLimit(env, cfg.env.max_episode_steps)
        env = RecordEpisodeStatistics(env)
        if cfg.env.get("capture_video", False) and rank == 0 and vector_env_idx == 0 and self.run_name is not None:
            if cfg.env.get("grayscale", False):
                env = GrayscaleRenderWrapper(env)
            video_dir = os.path.join(self.run_name, self.prefix + "_videos" if self.prefix else "videos")
            try:
                env = RecordVideo(env, video_dir)
            except ImportError:
                warnings.warn("Video capture unavailable; continuing without RecordVideo")
        return env


def make_env(cfg: Config, seed: int, rank: int, vector_env_idx: int = 0, run_name: Optional[str] = None,
             prefix: str = "") -> Callable[[], Any]:
    """The constructor of env ``vector_env_idx`` of rank ``rank``; with
    ``env.capture_video``, rank 0's env 0 records into ``<run_name>/videos``
    (``<run_name>/<prefix>_videos``)."""
    return _EnvFactory(cfg, seed, rank, vector_env_idx, run_name, prefix)


def _step_one(env: Any, action: Any) -> Tuple[Any, float, bool, bool, Dict[str, Any], Any]:
    """One env step with same-step autoreset: (obs, reward, terminated,
    truncated, info, final_obs); a finished env is reset, its reset
    observation returned and its last one in ``final_obs``."""
    obs, r, te, tr, info = env.step(action)
    final_obs = None
    if te or tr:
        final_obs = obs
        obs, _ = env.reset()
    return obs, float(r), bool(te), bool(tr), info, final_obs


def _stack(obs: List[Dict[str, np.ndarray]], space: Any) -> Dict[str, np.ndarray]:
    """The envs' observations stacked, each key in its space's dtype (as
    gymnasium's vector envs batch them)."""
    out = {k: np.stack([o[k] for o in obs]) for k in obs[0]}
    for k, v in out.items():
        dtype = getattr(space.spaces.get(k), "dtype", None) if hasattr(space, "spaces") else None
        if dtype is not None:
            out[k] = v.astype(dtype, copy=False)
    return out


def _merge(results: List[Tuple[Any, float, bool, bool, Dict[str, Any], Any]], space: Any):
    """The vector env's step result from each env's ``_step_one``."""
    n = len(results)
    rewards = np.array([r[1] for r in results], np.float64)
    terminated = np.array([r[2] for r in results], bool)
    truncated = np.array([r[3] for r in results], bool)
    info: Dict[str, Any] = {}
    done = terminated | truncated
    if done.any():
        fo = np.empty(n, dtype=object)
        fo[:] = [r[5] for r in results]
        ep_r, ep_l, ep_mask = np.zeros(n, np.float64), np.zeros(n, np.int64), np.zeros(n, bool)
        for i, r in enumerate(results):
            if done[i] and "episode" in r[4]:
                ep_r[i], ep_l[i], ep_mask[i] = r[4]["episode"]["r"], r[4]["episode"]["l"], True
        info["final_obs"], info["_final_obs"] = fo, done
        info["final_info"] = {"episode": {"r": ep_r, "l": ep_l, "_r": ep_mask}, "_episode": ep_mask}
    restarted = np.array([bool(r[4].get("restart_on_exception", False)) for r in results])
    if restarted.any():
        info["restart_on_exception"], info["_restart_on_exception"] = restarted, restarted
    return _stack([r[0] for r in results], space), rewards, terminated, truncated, info


class SyncVectorEnv:
    """Steps ``num_envs`` envs in this process; a finished env is reset in the
    same step."""

    def __init__(self, env_fns: List[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        obs = [env.reset(seed=None if seed is None else seed + i)[0] for i, env in enumerate(self.envs)]
        return _stack(obs, self.single_observation_space), {}

    def step(self, actions: Any):
        return _merge([_step_one(env, actions[i]) for i, env in enumerate(self.envs)], self.single_observation_space)

    def close(self) -> None:
        for env in self.envs:
            env.close()


def _async_worker(env_fn: Callable[[], Any], conn: Any) -> None:
    env = env_fn()
    try:
        conn.send(("ok", (env.observation_space, env.action_space)))
        while True:
            cmd, arg = conn.recv()
            if cmd == "reset":
                conn.send(("ok", env.reset(seed=arg)))
            elif cmd == "step":
                conn.send(("ok", _step_one(env, arg)))
            elif cmd == "close":
                conn.send(("ok", None))
                break
    except Exception as err:  # noqa: BLE001 - the parent re-raises it
        conn.send(("error", f"{type(err).__name__}: {err}"))
    finally:
        env.close()
        conn.close()


class AsyncVectorEnv:
    """Steps each env in a process of its own (``env.sync_env=False``); the
    same results as ``SyncVectorEnv``. The processes are spawned (forking a
    process that runs threads is unsafe), so each env constructor is sent
    pickled."""

    def __init__(self, env_fns: List[Callable[[], Any]]):
        ctx = mp.get_context("spawn")
        self.num_envs = len(env_fns)
        self._conns, self._procs = [], []
        for fn in env_fns:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_async_worker, args=(fn, child), daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        first = [self._recv(c) for c in self._conns][0]
        self.single_observation_space, self.single_action_space = first
        self._closed = False

    @staticmethod
    def _recv(conn: Any) -> Any:
        status, payload = conn.recv()
        if status != "ok":
            raise RuntimeError(f"an env worker failed: {payload}")
        return payload

    def reset(self, seed: Optional[int] = None, options: Optional[dict] = None):
        for i, c in enumerate(self._conns):
            c.send(("reset", None if seed is None else seed + i))
        return _stack([self._recv(c)[0] for c in self._conns], self.single_observation_space), {}

    def step(self, actions: Any):
        for i, c in enumerate(self._conns):
            c.send(("step", actions[i]))
        return _merge([self._recv(c) for c in self._conns], self.single_observation_space)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for c in self._conns:
            try:
                c.send(("close", None))
                c.recv()
            except (OSError, EOFError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


def vectorize(cfg: Config, seed: int, rank: int, restart_handled_by_loop: bool = False,
              run_name: Optional[str] = None, prefix: str = "") -> Any:
    """The vector env of ``env.num_envs`` envs: in this process
    (``env.sync_env``) or one process each. ``run_name`` (the run's log
    dir) is where ``env.capture_video`` records.

    Envs of the crash-prone suites (MineRL, DIAMBRA, MineDojo, read from
    ``env.wrapper._target_``) or any env with ``env.restart_on_exception``
    are wrapped in ``RestartOnException`` (``env.restart_window``,
    ``restart_maxfails``, ``restart_wait``). The crash step is reported as a
    truncation, unless the loop patches its buffer itself
    (``restart_handled_by_loop``, DreamerV3's ``patch_restarted_envs``).

    A transient failure while the vector env is built (an ``OSError`` and
    the like, not a configuration error) is retried with jittered backoff
    (``resilience.retries``, ``resilience/supervisor.py``)."""
    thunks = [make_env(cfg, seed + rank * cfg.env.num_envs + i, rank, i, run_name, prefix)
              for i in range(cfg.env.num_envs)]
    target = str(cfg.select("env.wrapper._target_") or "").lower()
    crash_prone = any(s in target for s in ("minerl", "diambra", "minedojo"))
    restart = cfg.env.get("restart_on_exception", None)
    if bool(crash_prone if restart is None else restart):
        thunks = [
            partial(RestartOnException, thunk, window=float(cfg.env.get("restart_window", 300.0)),
                    maxfails=int(cfg.env.get("restart_maxfails", 2)), wait=float(cfg.env.get("restart_wait", 0.0)),
                    report_truncated=not restart_handled_by_loop)
            for thunk in thunks
        ]
    def build() -> Any:
        return SyncVectorEnv(thunks) if cfg.env.get("sync_env", True) else AsyncVectorEnv(thunks)

    from ..resilience.supervisor import make_retrying

    retrying = make_retrying(cfg)
    return retrying(build, op="env_construction") if retrying is not None else build()


class ProbedSpaces(NamedTuple):
    """The spaces of the vector env an actor fleet's workers build, without
    the envs: what the fleet learner reads where a loop reads its vector
    env (``close`` is a no-op)."""

    single_observation_space: Any
    single_action_space: Any

    def close(self) -> None:
        pass


def probe_env_spaces(cfg: Config, seed: int) -> ProbedSpaces:
    """Build ONE fully wrapped env to read its spaces, then close it. The
    fleet learner never steps envs (its worker processes own them) but needs
    the spaces ``vectorize(...).single_*_space`` would report to build the
    agent."""
    env = make_env(cfg, seed, 0, 0)()
    try:
        return ProbedSpaces(env.observation_space, env.action_space)
    finally:
        env.close()


def single_env(cfg: Config, seed: int, run_name: Optional[str] = None) -> Any:
    """The first env of the run's pipeline (restarts included), in this
    process: the greedy test episode's (recorded under ``run_name`` with
    ``env.capture_video``)."""
    one = Config({**cfg.to_dict(), "env": {**cfg.env.to_dict(), "num_envs": 1, "sync_env": True}})
    return vectorize(one, seed, 0, run_name=run_name).envs[0]


def patch_restarted_envs(info: Dict[str, Any], dones: Any, rb: Any, step_data: Optional[Dict[str, Any]] = None):
    """For every env that restarted in flight (a crash, not an episode end),
    rewrite its last replay row as a truncation boundary and flag the
    incoming row ``is_first``. Returns the mask of restarted envs (the
    caller resets their recurrent state), or None."""
    roe = info.get("restart_on_exception")
    if roe is None:
        return None
    restarted = np.asarray(roe).reshape(-1).astype(bool)
    restarted &= ~np.asarray(dones).reshape(-1).astype(bool)
    if not restarted.any():
        return None
    for i in np.nonzero(restarted)[0]:
        rb.mark_restart(int(i))
        if step_data is not None and "is_first" in step_data:
            step_data["is_first"][0, i] = 1
    return restarted


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


def get_dummy_env(id: str, **suite_kwargs: Any) -> Any:
    """The dummy env named by ``id``. ``suite_kwargs`` (a suite's wrapper
    keys, where an experiment that names a suite runs on the dummy env
    instead) are not used."""
    from ..envs.dummy import ContinuousDummyEnv, CrashingDummyEnv, DiscreteDummyEnv, MultiDiscreteDummyEnv

    if "crashing" in id:
        return CrashingDummyEnv()
    if "continuous" in id:
        return ContinuousDummyEnv()
    if "multidiscrete" in id:
        return MultiDiscreteDummyEnv()
    if "discrete" in id:
        return DiscreteDummyEnv()
    raise ValueError(f"Unrecognized dummy environment: {id}")

