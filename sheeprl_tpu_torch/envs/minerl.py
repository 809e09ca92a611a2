"""The MineRL adapter (the port's own copy of ``sheeprl_tpu/envs/minerl.py``).

A flat Discrete action space enumerated from MineRL's dict action space
(the camera binned to 15-degree pitch/yaw moves, jump/sneak/sprint fused
with forward, an Enum action expanded per value), sticky attack and jump,
pitch limits, and the observation dict {rgb, life_stats, inventory,
max_inventory[, compass][, equipment]}, with a multi-hot item encoding over
MineRL's whole vocabulary (``multihot_inventory``) or over the task's
observed items.

The custom Navigate and Obtain specs with an adjustable break speed
(``minerl_envs/``) are taken by id (``custom_navigate``,
``custom_obtain_diamond``, ``custom_obtain_iron_pickaxe``); any other id
goes through MineRL's registry in the legacy ``gym.make``. The env is on the
port's own spaces; minerl and gym are imported when an adapter is built
(without MineRL the constructor raises the JAX package's
``ModuleNotFoundError``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..utils import imports
from . import spaces


class MineRLWrapper:
    """Holds the legacy MineRL env, with the gymnasium env interface on the
    port's spaces."""

    def __init__(
        self,
        id: str,
        height: int = 64,
        width: int = 64,
        pitch_limits: Tuple[int, int] = (-60, 60),
        seed: Optional[int] = None,
        sticky_attack: Optional[int] = 30,
        sticky_jump: Optional[int] = 10,
        break_speed_multiplier: Optional[int] = 100,
        multihot_inventory: bool = True,
        **kwargs: Any,
    ):
        imports.require(imports._IS_MINERL_AVAILABLE)
        import gym as legacy_gym
        import minerl  # noqa: F401  (registers MineRL's envs with gym)
        import minerl.herobraine.hero.spaces as hero_spaces
        from minerl.herobraine.hero import mc

        from .minerl_envs import custom_tasks

        self._item_ids = dict(zip(mc.ALL_ITEMS, range(len(mc.ALL_ITEMS))))
        self._height = height
        self._width = width
        self._pitch_limits = pitch_limits
        self._sticky_attack = 0 if break_speed_multiplier > 1 else sticky_attack
        self._sticky_jump = sticky_jump
        self._sticky_attack_counter = 0
        self._sticky_jump_counter = 0
        self._break_speed_multiplier = break_speed_multiplier
        self._multihot_inventory = multihot_inventory

        tasks = custom_tasks()
        if id.lower() in tasks:
            if "navigate" not in id.lower():
                kwargs.pop("extreme", None)
            spec = tasks[id.lower()](break_speed=break_speed_multiplier, resolution=(height, width), **kwargs)
            self.env = spec.make()
        else:
            self.env = legacy_gym.make(id)

        # the flat Discrete action space over MineRL's dict action space
        self.ACTIONS_MAP: Dict[int, Dict[str, Any]] = {0: {}}
        act_idx = 1
        for act in self.env.action_space:
            space = self.env.action_space[act]
            if isinstance(space, hero_spaces.Enum):
                act_val = sorted(set(space.values.tolist()) - {"none"})
            elif act != "camera":
                act_val = [1]
            else:
                act_val = [np.array([-15, 0]), np.array([15, 0]), np.array([0, -15]), np.array([0, 15])]
            mapped = {act_idx + i: {act: v} for i, v in enumerate(act_val)}
            if act in {"jump", "sneak", "sprint"}:
                mapped[act_idx]["forward"] = 1
            self.ACTIONS_MAP.update(mapped)
            act_idx += len(act_val)
        self.action_space = spaces.Discrete(len(self.ACTIONS_MAP))

        inv_dim = len(self._item_ids) if multihot_inventory else len(self.env.observation_space["inventory"].spaces)
        obs_space: Dict[str, spaces.Space] = {
            "rgb": spaces.Box(0, 255, (height, width, 3), np.uint8),
            "life_stats": spaces.Box(0.0, np.array([20.0, 20.0, 300.0]), (3,), np.float32),
            "inventory": spaces.Box(0.0, np.inf, (inv_dim,), np.float32),
            "max_inventory": spaces.Box(0.0, np.inf, (inv_dim,), np.float32),
        }
        if "compass" in self.env.observation_space.spaces:
            obs_space["compass"] = spaces.Box(-180.0, 180.0, (1,), np.float32)
        if "equipped_items" in self.env.observation_space.spaces:
            obs_space["equipment"] = spaces.Box(0.0, 1.0, (inv_dim,), np.int32)
        self.observation_space = spaces.Dict(obs_space)
        self._inventory_names = (
            None if multihot_inventory else sorted(self.env.observation_space["inventory"].spaces.keys())
        )
        self._max_inventory = np.zeros(inv_dim, np.float32)
        self._pos = {"pitch": 0.0, "yaw": 0.0}
        self.render_mode = "rgb_array"
        self.observation_space.seed(seed)
        self.action_space.seed(seed)

    def __getattr__(self, name):
        if name.startswith("_") or name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def unwrapped(self) -> "MineRLWrapper":
        return self

    def _item_index(self, name: str) -> Optional[int]:
        if self._multihot_inventory:
            return self._item_ids.get("_".join(name.split(" ")))
        try:
            return self._inventory_names.index(name)
        except ValueError:
            return None

    def _convert_inventory(self, inventory: Dict[str, Any]) -> np.ndarray:
        dim = self.observation_space["inventory"].shape[0]
        counts = np.zeros(dim, np.float32)
        for item, quantity in inventory.items():
            idx = self._item_index(item)
            if idx is not None:
                counts[idx] += float(np.asarray(quantity).sum())
        self._max_inventory = np.maximum(counts, self._max_inventory)
        return counts

    def _convert_action(self, action: int) -> Dict[str, Any]:
        chosen = self.ACTIONS_MAP[int(np.asarray(action).squeeze())]
        converted = self.env.action_space.noop()
        for k, v in chosen.items():
            converted[k] = v
        # sticky attack and jump
        if self._sticky_attack:
            if converted.get("attack", 0):
                self._sticky_attack_counter = self._sticky_attack - 1
            elif self._sticky_attack_counter > 0:
                converted["attack"] = 1
                self._sticky_attack_counter -= 1
        if self._sticky_jump:
            if converted.get("jump", 0):
                self._sticky_jump_counter = self._sticky_jump - 1
            elif self._sticky_jump_counter > 0:
                converted["jump"] = 1
                if not converted.get("forward", 0) and not converted.get("back", 0):
                    converted["forward"] = 1
                self._sticky_jump_counter -= 1
        # the pitch held within its limits
        cam = np.asarray(converted.get("camera", np.zeros(2)), np.float32)
        next_pitch = self._pos["pitch"] + cam[0]
        if not (self._pitch_limits[0] <= next_pitch <= self._pitch_limits[1]):
            cam[0] = 0.0
            converted["camera"] = cam
        return converted

    def _convert_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {"rgb": np.asarray(obs["pov"], np.uint8)}
        life = obs.get("life_stats", {})
        out["life_stats"] = np.array(
            [
                float(np.asarray(life.get("life", 20.0)).item()),
                float(np.asarray(life.get("food", 20.0)).item()),
                float(np.asarray(life.get("air", 300.0)).item()),
            ],
            np.float32,
        )
        out["inventory"] = self._convert_inventory(obs.get("inventory", {}))
        out["max_inventory"] = self._max_inventory.copy()
        if "compass" in self.observation_space.spaces:
            out["compass"] = np.asarray([np.asarray(obs["compass"]["angle"]).item()], np.float32)
        if "equipment" in self.observation_space.spaces:
            equip = np.zeros(self.observation_space["equipment"].shape[0], np.int32)
            eq = obs.get("equipped_items", {}).get("mainhand", {})
            idx = self._item_index(str(eq.get("type", "air")))
            if idx is not None:
                equip[idx] = 1
            out["equipment"] = equip
        return out

    def step(self, action):
        converted = self._convert_action(action)
        obs, reward, done, info = self.env.step(converted)
        cam = np.asarray(converted.get("camera", np.zeros(2)), np.float32)
        self._pos["pitch"] = float(self._pos["pitch"] + cam[0])
        self._pos["yaw"] = float(self._pos["yaw"] + cam[1])
        is_timelimit = bool(info.get("TimeLimit.truncated", False))
        return self._convert_obs(obs), reward, done and not is_timelimit, done and is_timelimit, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs = self.env.reset()
        self._sticky_attack_counter = 0
        self._sticky_jump_counter = 0
        self._max_inventory[:] = 0
        self._pos = {"pitch": 0.0, "yaw": 0.0}
        return self._convert_obs(obs), {}

    def render(self):
        return getattr(self.env.unwrapped, "_last_pov", None)

    def close(self):
        return self.env.close()
