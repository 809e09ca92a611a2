"""The MineDojo adapter (the port's own copy of ``sheeprl_tpu/envs/minedojo.py``).

``minedojo.make``'s ARNN action space becomes the three-head MultiDiscrete
space the DreamerV3 ``MinedojoActor`` takes, [action type (19), craft item,
inventory item], with:

* the 19-entry ``ACTION_MAP`` over movement, camera and functional actions;
* sticky attack and jump (attack keeps firing ``sticky_attack`` steps, jump
  ``sticky_jump``; a conflicting choice cancels them);
* the pitch held within ``pitch_limits`` (the camera bin is dropped at a
  limit);
* the observation dict {rgb, inventory, inventory_max, inventory_delta,
  equipment, life_stats, mask_action_type, mask_equip_place, mask_destroy,
  mask_craft_smelt}, whose masks gate the actor's heads
  (``algos/dreamer_v3/agent.py:apply_minedojo_masks``).

The action table, the observation fields and the masks are the contract with
``MinedojoActor``. The env is on the port's own spaces; minedojo is imported
when an adapter is built (without it the constructor raises the JAX
package's ``ModuleNotFoundError``), and the item vocabularies with it.
"""
from __future__ import annotations

import copy
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..utils import imports
from . import spaces

# ARNN action vector slots
_MOVE, _STRAFE, _BODY, _PITCH, _YAW, _FN, _CRAFT_ARG, _SLOT_ARG = range(8)
# camera bins are 15 degrees; bin 12 holds still
_CAM_NOOP, _CAM_DOWN, _CAM_UP = 12, 11, 13
# functional-slot values
_FN_NOOP, _FN_USE, _FN_DROP, _FN_ATTACK, _FN_CRAFT, _FN_EQUIP, _FN_PLACE, _FN_DESTROY = range(8)
_FN_NEEDS_SLOT = (_FN_EQUIP, _FN_PLACE, _FN_DESTROY)
_BODY_JUMP = 1


def _arnn(move=0, strafe=0, body=0, pitch=_CAM_NOOP, yaw=_CAM_NOOP, fn=_FN_NOOP) -> np.ndarray:
    """One row of the 8-slot ARNN action vector (the craft and slot
    arguments are filled when it is sent)."""
    return np.array([move, strafe, body, pitch, yaw, fn, 0, 0])


# The 19 macro-actions of the DreamerV3 MineDojo actor: index -> primitive action
ACTION_MAP: Dict[int, np.ndarray] = {
    0: _arnn(),                      # no-op
    1: _arnn(move=1),                # forward
    2: _arnn(move=2),                # back
    3: _arnn(strafe=1),              # left
    4: _arnn(strafe=2),              # right
    5: _arnn(move=1, body=1),        # jump + forward
    6: _arnn(move=1, body=2),        # sneak + forward
    7: _arnn(move=1, body=3),        # sprint + forward
    8: _arnn(pitch=_CAM_DOWN),       # look down
    9: _arnn(pitch=_CAM_UP),         # look up
    10: _arnn(yaw=_CAM_DOWN),        # turn left
    11: _arnn(yaw=_CAM_UP),          # turn right
    12: _arnn(fn=_FN_USE),
    13: _arnn(fn=_FN_DROP),
    14: _arnn(fn=_FN_ATTACK),
    15: _arnn(fn=_FN_CRAFT),
    16: _arnn(fn=_FN_EQUIP),
    17: _arnn(fn=_FN_PLACE),
    18: _arnn(fn=_FN_DESTROY),
}


class Vocab(NamedTuple):
    """minedojo's item vocabularies: the items, the craftable/smeltable
    ones, name -> id and id -> name, and the task registry as imported."""

    all_items: List[str]
    craft_smelt_items: List[str]
    name_to_id: Dict[str, int]
    id_to_name: Dict[int, str]
    tasks_specs: Dict[str, Any]


@functools.lru_cache(maxsize=None)
def vocab() -> Vocab:
    imports.require(imports._IS_MINEDOJO_AVAILABLE)
    import minedojo.tasks
    from minedojo.sim import ALL_CRAFT_SMELT_ITEMS, ALL_ITEMS

    return Vocab(list(ALL_ITEMS), list(ALL_CRAFT_SMELT_ITEMS), {n: i for i, n in enumerate(ALL_ITEMS)},
                 dict(enumerate(ALL_ITEMS)), copy.deepcopy(minedojo.tasks.ALL_TASKS_SPECS))


def _norm(name: str) -> str:
    return "_".join(name.split(" "))


class MineDojoWrapper:
    """Holds the legacy minedojo env, with the gymnasium env interface on the
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
        **kwargs: Any,
    ):
        self._vocab = vocab()
        import minedojo
        import minedojo.tasks

        self._height, self._width = height, width
        self._pitch_limits = pitch_limits
        self._break_speed = kwargs.pop("break_speed_multiplier", 100)
        self._pos = kwargs.get("start_position", None)
        self._start_pos = copy.deepcopy(self._pos)
        if self._pos is not None:
            lo, hi = pitch_limits
            if not lo <= self._pos["pitch"] <= hi:
                raise ValueError(f"start_position pitch {self._pos['pitch']} outside pitch_limits [{lo}, {hi}]")

        # where blocks break in one hit, holding the attack button adds
        # nothing: sticky attack only matters at the natural break speed
        self._sticky_attack = sticky_attack if self._break_speed <= 1 else 0
        self._sticky_jump = sticky_jump
        self._attack_ttl = 0
        self._jump_ttl = 0

        self.env = minedojo.make(
            task_id=id,
            image_size=(height, width),
            world_seed=seed,
            fast_reset=True,
            break_speed_multiplier=self._break_speed,
            **kwargs,
        )
        self._slots_by_item: Dict[str, List[int]] = {}
        self._slot_names: Optional[np.ndarray] = None
        self._inventory_max = self._item_vec()

        n_items, n_craft = len(self._vocab.all_items), len(self._vocab.craft_smelt_items)
        self.action_space = spaces.MultiDiscrete(np.array([len(ACTION_MAP), n_craft, n_items]))

        def per_item(lo, hi, dt):
            return spaces.Box(lo, hi, (n_items,), dt)

        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, self.env.observation_space["rgb"].shape, np.uint8),
                "inventory": per_item(0.0, np.inf, np.float32),
                "inventory_max": per_item(0.0, np.inf, np.float32),
                "inventory_delta": per_item(-np.inf, np.inf, np.float32),
                "equipment": per_item(0.0, 1.0, np.int32),
                "life_stats": spaces.Box(0.0, np.array([20.0, 20.0, 300.0]), (3,), np.float32),
                "mask_action_type": spaces.Box(0, 1, (len(ACTION_MAP),), bool),
                "mask_equip_place": per_item(0, 1, bool),
                "mask_destroy": per_item(0, 1, bool),
                "mask_craft_smelt": spaces.Box(0, 1, (n_craft,), bool),
            }
        )
        self.render_mode = "rgb_array"
        self.seed(seed=seed)
        # minedojo.make mutates the global task registry: put it back
        minedojo.tasks.ALL_TASKS_SPECS = copy.deepcopy(self._vocab.tasks_specs)

    def __getattr__(self, name):
        if name.startswith("_") or name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def unwrapped(self) -> "MineDojoWrapper":
        return self

    def _item_vec(self, dtype=np.float64) -> np.ndarray:
        return np.zeros(len(self._vocab.all_items), dtype=dtype)

    # -- observation conversion -------------------------------------------
    def _scan_inventory(self, inventory: Dict[str, Any]) -> np.ndarray:
        """Counts per item id; also rebuilds the item -> slot map that sends
        equip/place/destroy to a slot of the inventory."""
        names = [_norm(n) for n in inventory["name"].tolist()]
        self._slot_names = np.asarray(names)
        self._slots_by_item = {}
        counts = self._item_vec()
        for slot, (item, qty) in enumerate(zip(names, inventory["quantity"])):
            self._slots_by_item.setdefault(item, []).append(slot)
            # "air" fills a slot but reports no quantity: count the slot
            counts[self._vocab.name_to_id[item]] += 1 if item == "air" else qty
        self._inventory_max = np.maximum(counts, self._inventory_max)
        return counts

    def _scan_delta(self, delta: Dict[str, Any]) -> np.ndarray:
        out = self._item_vec()
        for prefix in ("craft", "other"):
            for sign, way in ((+1, "inc"), (-1, "dec")):
                names = delta[f"{way}_name_by_{prefix}"]
                quantities = delta[f"{way}_quantity_by_{prefix}"]
                for item, qty in zip(names, quantities):
                    out[self._vocab.name_to_id[_norm(item)]] += sign * qty
        return out

    def _scan_equipment(self, equipment: Dict[str, Any]) -> np.ndarray:
        onehot = self._item_vec(np.int32)
        onehot[self._vocab.name_to_id[_norm(equipment["name"][0])]] = 1
        return onehot

    def _scan_masks(self, masks: Dict[str, Any]) -> Dict[str, np.ndarray]:
        equip_mask = self._item_vec(bool)
        destroy_mask = self._item_vec(bool)
        for item, can_equip, can_destroy in zip(self._slot_names, masks["equip"], masks["destroy"]):
            idx = self._vocab.name_to_id[item]
            equip_mask[idx] |= bool(can_equip)
            destroy_mask[idx] |= bool(can_destroy)
        # equip/place need something equippable in the inventory, destroy
        # something destroyable; movement and camera (the first 12
        # macro-actions) are always allowed
        fn_mask = np.asarray(masks["action_type"], dtype=bool).copy()
        fn_mask[5:7] &= equip_mask.any()
        fn_mask[7] &= destroy_mask.any()
        return {
            "mask_action_type": np.concatenate((np.ones(12, dtype=bool), fn_mask[1:])),
            "mask_equip_place": equip_mask,
            "mask_destroy": destroy_mask,
            "mask_craft_smelt": np.asarray(masks["craft_smelt"], dtype=bool),
        }

    def _convert_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        life = obs["life_stats"]
        return {
            "rgb": obs["rgb"].copy(),
            "inventory": self._scan_inventory(obs["inventory"]),
            "inventory_max": self._inventory_max,
            "inventory_delta": self._scan_delta(obs["delta_inv"]),
            "equipment": self._scan_equipment(obs["equipment"]),
            "life_stats": np.concatenate((life["life"], life["food"], life["oxygen"])),
            **self._scan_masks(obs["masks"]),
        }

    # -- action conversion -------------------------------------------------
    def _apply_sticky(self, arnn: np.ndarray) -> None:
        """An attack (jump) choice arms a countdown that re-issues it on no-op
        steps; a conflicting choice disarms it."""
        if self._sticky_attack:
            if arnn[_FN] == _FN_ATTACK:
                self._attack_ttl = self._sticky_attack - 1
            elif arnn[_FN] == _FN_NOOP and self._attack_ttl > 0:
                arnn[_FN] = _FN_ATTACK
                self._attack_ttl -= 1
            else:
                self._attack_ttl = 0
        if self._sticky_jump:
            if arnn[_BODY] == _BODY_JUMP:
                self._jump_ttl = self._sticky_jump - 1
            elif arnn[_MOVE] == 0 and self._jump_ttl > 0:
                arnn[_BODY] = _BODY_JUMP
                if arnn[_STRAFE] == 0:
                    # an undirected sticky jump keeps the forward momentum
                    arnn[_MOVE] = 1
                self._jump_ttl -= 1
            elif arnn[_BODY] != _BODY_JUMP:
                self._jump_ttl = 0

    def _convert_action(self, action: np.ndarray) -> np.ndarray:
        arnn = ACTION_MAP[int(action[0])].copy()
        self._apply_sticky(arnn)
        arnn[_CRAFT_ARG] = int(action[1]) if arnn[_FN] == _FN_CRAFT else 0
        if arnn[_FN] in _FN_NEEDS_SLOT:
            arnn[_SLOT_ARG] = self._slots_by_item[self._vocab.id_to_name[int(action[2])]][0]
        else:
            arnn[_SLOT_ARG] = 0
        return arnn

    # -- the env interface ---------------------------------------------------
    @staticmethod
    def _position_of(obs: Dict[str, Any]) -> Dict[str, float]:
        loc = obs["location_stats"]
        x, y, z = (float(v) for v in loc["pos"])
        return {"x": x, "y": y, "z": z, "pitch": float(loc["pitch"].item()), "yaw": float(loc["yaw"].item())}

    def _stats_info(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        life = obs["life_stats"]
        return {
            "life_stats": {
                "life": float(life["life"].item()),
                "oxygen": float(life["oxygen"].item()),
                "food": float(life["food"].item()),
            },
            "location_stats": copy.deepcopy(self._pos),
            "biomeid": float(obs["location_stats"]["biome_id"].item()),
        }

    def seed(self, seed: Optional[int] = None) -> None:
        self.observation_space.seed(seed)
        self.action_space.seed(seed)

    def step(self, action: np.ndarray):
        raw = np.asarray(action)
        arnn = self._convert_action(raw)
        # hold the camera where the pitch bin would leave the allowed range
        pitch_after = self._pos["pitch"] + (arnn[_PITCH] - _CAM_NOOP) * 15
        if not self._pitch_limits[0] <= pitch_after <= self._pitch_limits[1]:
            arnn[_PITCH] = _CAM_NOOP
        obs, reward, done, info = self.env.step(arnn)
        timelimit = bool(info.get("TimeLimit.truncated", False))
        self._pos = self._position_of(obs)
        info.update(self._stats_info(obs))
        info["action"] = raw.tolist()
        return self._convert_obs(obs), reward, done and not timelimit, done and timelimit, info

    def reset(self, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None):
        obs = self.env.reset()
        self._pos = self._position_of(obs)
        self._attack_ttl = 0
        self._jump_ttl = 0
        self._inventory_max = self._item_vec()
        return self._convert_obs(obs), self._stats_info(obs)

    def render(self):
        if self.render_mode == "human":
            return self.env.render()
        if self.render_mode == "rgb_array":
            prev = self.env.unwrapped._prev_obs
            return None if prev is None else prev["rgb"]
        return None

    def close(self) -> None:
        self.env.close()
