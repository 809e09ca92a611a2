"""The DIAMBRA Arena adapter (the port's own copy of
``sheeprl_tpu/envs/diambra.py``).

One flattened dict observation whose Discrete and MultiDiscrete leaves are
lifted to int32 Boxes (the encoder takes homogeneous arrays); the frame
shaped by the engine under ``increase_performance`` (cheaper than a Python
wrapper) or else by the arena's wrappers; sticky actions force the engine's
step ratio to 1; ``env_domain`` in the infos and ``env_done`` ends an
episode. The env is on the port's own spaces: the arena's gymnasium spaces
are read by their attributes (``low``/``high``, ``nvec``, ``n``), so no
gymnasium is imported here.

diambra is imported when an adapter is built: without it the constructor
raises the JAX package's ``ModuleNotFoundError``.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from ..utils import imports
from . import spaces
from .wrappers import Wrapper

# knobs this adapter owns: user values are dropped with a warning (the frame
# is shaped through increase_performance; flattening and the action repeat
# are set below)
_MANAGED_SETTINGS = ("frame_shape", "n_players")
_MANAGED_WRAPPERS = ("frame_shape", "stack_frames", "dilation", "flatten")


def _drop_managed(options: Dict[str, Any], managed: Tuple[str, ...], kind: str) -> Dict[str, Any]:
    out = dict(options)
    for key in managed:
        if out.pop(key, None) is not None:
            warnings.warn(f"The DIAMBRA {key} {kind} is disabled")
    return out


def _build_settings(game_id: str, raw: Dict[str, Any], action_space: str, render_mode: str, repeat_action: int):
    """The arena's ``EnvironmentSettings`` from the config's
    ``diambra_settings``."""
    import diambra.arena

    raw = _drop_managed(raw, _MANAGED_SETTINGS, "setting")
    role = raw.pop("role", None)
    if action_space not in ("DISCRETE", "MULTI_DISCRETE"):
        raise ValueError(
            "The valid values for the `action_space` attribute are "
            f"'DISCRETE' or 'MULTI_DISCRETE', got {action_space}"
        )
    if role not in (None, "P1", "P2"):
        raise ValueError(f"`role` must be 'P1', 'P2' or None, got {role}")
    if repeat_action > 1:
        # sticky actions need a 1:1 engine step ratio
        if raw.get("step_ratio", 6) > 1:
            warnings.warn(
                f"step_ratio parameter modified to 1 because the sticky action is active ({repeat_action})"
            )
        raw["step_ratio"] = 1
    raw.update(
        game_id=game_id,
        n_players=1,
        action_space=getattr(diambra.arena.SpaceTypes, action_space, diambra.arena.SpaceTypes.DISCRETE),
        role=None if role is None else getattr(diambra.arena.Roles, role, diambra.arena.Roles.P1),
        render_mode=render_mode,
    )
    return diambra.arena.EnvironmentSettings(**raw)


def _lift_space(space: Any) -> spaces.Box:
    """An observation leaf as a port Box: a Box passes (its bounds, shape and
    dtype), a Discrete becomes ``Box(0, n - 1, (1,), int32)``, a
    MultiDiscrete ``Box(0, nvec - 1, (len,), int32)``; anything else is
    refused."""
    if hasattr(space, "low") and hasattr(space, "high"):
        return spaces.Box(space.low, space.high, space.shape, space.dtype)
    if hasattr(space, "nvec"):
        top = np.asarray(space.nvec) - 1
        return spaces.Box(np.zeros_like(top), top, (len(top),), np.int32)
    if hasattr(space, "n"):
        return spaces.Box(0, int(space.n) - 1, (1,), np.int32)
    raise RuntimeError(f"Invalid observation space, got: {type(space)}")


def _action_space(space: Any) -> spaces.Space:
    if hasattr(space, "nvec"):
        return spaces.MultiDiscrete(np.asarray(space.nvec))
    return spaces.Discrete(int(space.n))


class DiambraWrapper(Wrapper):
    def __init__(
        self,
        id: str,
        action_space: str = "DISCRETE",
        screen_size: Union[int, Tuple[int, int]] = 64,
        grayscale: bool = False,
        repeat_action: int = 1,
        rank: int = 0,
        diambra_settings: Optional[Dict[str, Any]] = None,
        diambra_wrappers: Optional[Dict[str, Any]] = None,
        render_mode: str = "rgb_array",
        log_level: int = 0,
        increase_performance: bool = True,
    ) -> None:
        imports.require(imports._IS_DIAMBRA_AVAILABLE)
        import diambra.arena

        self._action_type = action_space.lower()
        self._render_mode = render_mode
        frame_shape = (screen_size, screen_size) if isinstance(screen_size, int) else tuple(screen_size)
        frame_shape = frame_shape + (int(grayscale),)

        settings = _build_settings(id, dict(diambra_settings or {}), action_space, render_mode, repeat_action)
        wrapper_opts = _drop_managed(dict(diambra_wrappers or {}), _MANAGED_WRAPPERS, "wrapper")
        # the constructor's knobs win over the dict's duplicates
        wrapper_opts.update(flatten=True, repeat_action=repeat_action)
        wrappers = diambra.arena.WrappersSettings(**wrapper_opts)
        # the engine rescales more cheaply than the wrapper does
        target = settings if increase_performance else wrappers
        target.frame_shape = frame_shape

        super().__init__(
            diambra.arena.make(id, settings, wrappers, rank=rank, render_mode=render_mode, log_level=log_level)
        )
        self._action_space = _action_space(self.env.action_space)
        self.observation_space = spaces.Dict(
            {k: _lift_space(s) for k, s in self.env.observation_space.spaces.items()}
        )

    @property
    def action_space(self) -> spaces.Space:
        return self._action_space

    @property
    def render_mode(self) -> Optional[str]:
        return self._render_mode

    def _convert_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v).reshape(self.observation_space[k].shape) for k, v in obs.items()}

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs, infos = self.env.reset(seed=seed, options=options)
        infos["env_domain"] = "DIAMBRA"
        return self._convert_obs(obs), infos

    def step(self, action: Any):
        if self._action_type == "discrete" and isinstance(action, np.ndarray):
            action = action.squeeze().item()
        obs, reward, terminated, truncated, infos = self.env.step(action)
        infos["env_domain"] = "DIAMBRA"
        # the engine flags the end of a whole game with env_done
        done = terminated or infos.get("env_done", False)
        return self._convert_obs(obs), reward, done, truncated, infos

    def render(self):
        return self.env.render()
