"""Stand-in for diambra-arena 2.2.x (``diambra.arena``).

Mirrors: ``EnvironmentSettings`` and ``WrappersSettings`` (dataclasses with
the fields the presets and adapters set: an unknown key is a ``TypeError``,
attributes stay assignable), ``SpaceTypes`` (``DISCRETE``,
``MULTI_DISCRETE``), ``Roles`` (``P1``, ``P2``) and ``make(game_id,
env_settings, wrappers_settings, episode_recording_settings=None,
render_mode=None, rank=0, log_level=0)``, which returns a gymnasium env
(the arena is gymnasium-based) with the flattened, role-relative
observation dict of Dead Or Alive++ (``frame`` of the settings' or the
wrappers' ``frame_shape``: ``(H, W, 0)`` keeps three channels, ``(H, W, 1)``
is gray; ``stage``, ``timer``, ``own_health``, ``opp_health``, ``own_wins``
as int Boxes; ``own_side``, ``opp_side``, ``own_character``,
``opp_character`` as Discrete; ``action`` the last action, Discrete or
MultiDiscrete), a Discrete(9 + 8 - 1) or MultiDiscrete([9, 8]) action
space, 5-tuple steps with ``info["env_done"]`` at the end of a game, and
``render()``. The env keeps the settings it was made with
(``env_settings``, ``wrappers_settings``).

The fight is not the game: a deterministic toy (health lost by a draw from
a generator seeded by the reset seed, or by ``rank`` and the episode
number; a round ends when one side's health is gone, the game after two
won rounds).
"""
import enum
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import gymnasium as gym
import numpy as np

__version__ = "2.2.2-stand-in"


class SpaceTypes(enum.IntEnum):
    DISCRETE = 0
    MULTI_DISCRETE = 1


class Roles(enum.IntEnum):
    P1 = 0
    P2 = 1


@dataclass
class EnvironmentSettings:
    game_id: Optional[str] = None
    frame_shape: Tuple[int, int, int] = (0, 0, 0)
    step_ratio: int = 6
    disable_keyboard: bool = True
    disable_joystick: bool = True
    render_mode: Optional[str] = None
    splash_screen: bool = True
    rank: int = 0
    env_address: Optional[str] = None
    grpc_timeout: int = 600
    seed: Optional[int] = None
    difficulty: Optional[int] = None
    continue_game: float = 0.0
    show_final: bool = False
    tower: Optional[int] = 3
    n_players: int = 1
    action_space: Any = SpaceTypes.MULTI_DISCRETE
    role: Any = None
    characters: Any = None
    outfits: Optional[int] = None
    super_art: Any = None
    fatal_blow: Any = None
    costume: Any = None


@dataclass
class WrappersSettings:
    no_op_max: int = 0
    repeat_action: int = 1
    normalize_reward: bool = False
    normalization_factor: float = 0.5
    clip_reward: bool = False
    no_attack_buttons_combinations: bool = False
    frame_shape: Tuple[int, int, int] = (0, 0, 0)
    stack_frames: int = 1
    dilation: int = 1
    add_last_action: bool = False
    stack_actions: int = 1
    scale: bool = False
    exclude_image_scaling: bool = False
    process_discrete_binary: bool = False
    role_relative: bool = False
    flatten: bool = False
    filter_keys: Any = None
    wrappers: Any = None


_NATIVE = (480, 512)
_MOVES, _ATTACKS, _CHARACTERS = 9, 8, 11


class _Arena(gym.Env):
    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, game_id, env_settings, wrappers_settings, render_mode, rank):
        self.game_id = game_id
        self.env_settings = env_settings
        self.wrappers_settings = wrappers_settings
        self.render_mode = render_mode
        self._rank = rank
        shape = tuple(env_settings.frame_shape)
        if not any(shape[:2]):
            shape = tuple(wrappers_settings.frame_shape)
        h, w = shape[:2] if any(shape[:2]) else _NATIVE
        self._frame_shape = (h, w, 1 if shape[2] == 1 else 3)
        if env_settings.action_space == SpaceTypes.DISCRETE:
            self.action_space = gym.spaces.Discrete(_MOVES + _ATTACKS - 1)
        else:
            self.action_space = gym.spaces.MultiDiscrete([_MOVES, _ATTACKS])
        self.observation_space = gym.spaces.Dict({
            "frame": gym.spaces.Box(0, 255, self._frame_shape, np.uint8),
            "stage": gym.spaces.Box(1, 8, (1,), np.int8),
            "timer": gym.spaces.Box(0, 40, (1,), np.int8),
            "own_health": gym.spaces.Box(0, 208, (1,), np.int16),
            "opp_health": gym.spaces.Box(0, 208, (1,), np.int16),
            "own_wins": gym.spaces.Box(0, 2, (1,), np.int8),
            "own_side": gym.spaces.Discrete(2),
            "opp_side": gym.spaces.Discrete(2),
            "own_character": gym.spaces.Discrete(_CHARACTERS),
            "opp_character": gym.spaces.Discrete(_CHARACTERS),
            "action": self.action_space,
        })
        self._episode = 0

    def _obs(self, action):
        h, w, c = self._frame_shape
        frame = np.empty((h, w, c), np.uint8)
        frame[...] = (self._own * 251 + self._opp * 7 + self._timer) % 256
        frame[: h // 4, : int(w * self._own / 208)] = 255
        return {"frame": frame, "stage": np.array([self._stage], np.int8),
                "timer": np.array([self._timer], np.int8), "own_health": np.array([self._own], np.int16),
                "opp_health": np.array([self._opp], np.int16), "own_wins": np.array([self._wins], np.int8),
                "own_side": int(self._own > self._opp), "opp_side": int(self._own <= self._opp),
                "own_character": 3, "opp_character": int(self._stage % _CHARACTERS), "action": action}

    def _noop(self):
        return 0 if isinstance(self.action_space, gym.spaces.Discrete) else np.zeros(2, np.int64)

    def reset(self, *, seed=None, options=None):
        self._episode += 1
        self._rng = np.random.default_rng(seed if seed is not None else [int(self._rank or 0), self._episode])
        self._stage, self._own, self._opp, self._wins, self._timer = 1, 208, 208, 0, 40
        self._last = self._obs(self._noop())
        return self._last, {"settings": self.env_settings}

    def step(self, action):
        attack = int(np.asarray(action).reshape(-1)[-1]) > 0
        self._opp -= int(self._rng.integers(0, 40)) * attack
        self._own -= int(self._rng.integers(0, 30))
        self._timer -= 1
        reward = 0.0
        round_done = self._own <= 0 or self._opp <= 0 or self._timer <= 0
        info = {"round_done": round_done, "stage_done": False, "game_done": False, "episode_done": False,
                "env_done": False}
        terminated = False
        if round_done:
            won = self._opp < self._own
            reward = 1.0 if won else -1.0
            self._wins += int(won)
            if won and self._wins >= 2:
                info["stage_done"] = True
                self._stage += 1
                self._wins = 0
            elif not won:
                info["game_done"] = info["episode_done"] = terminated = True
                info["env_done"] = self._stage >= 2
            self._own, self._opp, self._timer = 208, 208, 40
        self._last = self._obs(action)
        return self._last, reward, terminated, False, info

    def render(self):
        return self._last["frame"]


def make(game_id, env_settings=None, wrappers_settings=None, episode_recording_settings=None, render_mode=None,
         rank=0, log_level=0):
    env_settings = env_settings if env_settings is not None else EnvironmentSettings(game_id=game_id)
    wrappers_settings = wrappers_settings if wrappers_settings is not None else WrappersSettings()
    return _Arena(game_id, env_settings, wrappers_settings, render_mode, rank)
