"""Stand-in for MineDojo 0.1 (``minedojo.make``, ``minedojo.sim``,
``minedojo.tasks``).

Mirrors: ``make(task_id, image_size, world_seed, fast_reset,
break_speed_multiplier, start_position, ...)`` of a task of
``tasks.ALL_TASKS_SPECS``, returning a legacy env whose observation space
holds ``rgb`` of shape ``(3, H, W)`` uint8; ``reset()`` returns the
observation and ``step(action)`` takes the 8-slot ARNN action vector
([move, strafe, body, pitch bin, yaw bin, functional, craft argument,
inventory slot]; camera bins of 15 degrees, 12 holds still) and returns
``(obs, reward, done, info)``, ``info["TimeLimit.truncated"]`` at the time
limit. The observation dict: ``rgb``; ``inventory`` (36 slots: ``name``,
``quantity``); ``delta_inv`` (``inc|dec_name|quantity_by_craft|other``);
``equipment`` (``name``, the main hand first); ``life_stats`` (``life``,
``food``, ``oxygen``); ``masks`` (``action_type`` over the 8 functional
actions, ``equip`` and ``destroy`` per slot, ``craft_smelt`` per item of
``ALL_CRAFT_SMELT_ITEMS``); ``location_stats`` (``pos``, ``pitch``,
``yaw``, ``biome_id``). ``unwrapped._prev_obs`` is the last observation.

The world is not Minecraft: a deterministic toy from ``world_seed`` (0
where none is given) and the episode number, over the reduced item
vocabulary of ``minedojo.sim``. Attacking gathers items, crafting turns
planks into the chosen item, equip/place/destroy act on the slot; damage is
drawn from the generator, so an episode ends at a death or after
``MAX_STEPS`` steps.
"""
import copy

import numpy as np

from . import sim, tasks

__version__ = "0.1-stand-in"
MAX_STEPS = 3000
_SLOTS, _EQUIP = 36, 6
_GATHER = ("dirt", "log", "log", "cobblestone", "coal", "iron_ore", "wheat")


def _spaced(name):
    return name.replace("_", " ")


class _Box:
    def __init__(self, shape):
        self.shape = tuple(shape)


class _Sim:
    def __init__(self, task_id, image_size, world_seed, break_speed_multiplier, start_position, spec):
        self.task_id = task_id
        self._h, self._w = image_size
        self._seed = 0 if world_seed is None else int(world_seed)
        self._break = break_speed_multiplier
        self._start = copy.deepcopy(start_position)
        self._spec = spec
        self.observation_space = {"rgb": _Box((3, self._h, self._w))}
        self._episode = 0
        self._prev_obs = None

    @property
    def unwrapped(self):
        return self

    def reset(self):
        self._episode += 1
        self._rng = np.random.default_rng([self._seed, self._episode])
        self._steps = 0
        start = self._start or {"x": 0.5, "y": 64.0, "z": 0.5, "pitch": 0.0, "yaw": 0.0}
        self._pos = np.array([start["x"], start["y"], start["z"]], np.float64)
        self._pitch, self._yaw = float(start["pitch"]), float(start["yaw"])
        self._inv = [["air", 0] for _ in range(_SLOTS)]
        mainhand = self._spec.get("initial_inventory", {}).get("mainhand")
        if mainhand:
            self._inv[0] = [mainhand["name"], 1]
        self._inv[1] = ["planks", 4]
        self._mainhand = 0
        self._life, self._food = 20.0, 20.0
        self._delta = self._no_delta()
        return self._observe()

    @staticmethod
    def _no_delta():
        return {f"{way}_{what}_by_{src}": [] for way in ("inc", "dec") for what in ("name", "quantity")
                for src in ("craft", "other")}

    def _add(self, name, qty, src):
        for slot in self._inv:
            if slot[0] == name:
                slot[1] += qty
                break
        else:
            for slot in self._inv:
                if slot[0] == "air":
                    slot[0], slot[1] = name, qty
                    break
            else:
                return
        self._delta[f"inc_name_by_{src}"].append(_spaced(name))
        self._delta[f"inc_quantity_by_{src}"].append(qty)

    def _take(self, slot, qty, src):
        name, have = self._inv[slot]
        if name == "air" or have <= 0:
            return False
        self._inv[slot][1] -= qty
        if self._inv[slot][1] <= 0:
            self._inv[slot] = ["air", 0]
        self._delta[f"dec_name_by_{src}"].append(_spaced(name))
        self._delta[f"dec_quantity_by_{src}"].append(qty)
        return True

    def _planks_slot(self):
        return next((i for i, (n, q) in enumerate(self._inv) if n == "planks" and q > 0), None)

    def _observe(self):
        names = np.array([_spaced(n) for n, _ in self._inv])
        quantity = np.array([0 if n == "air" else q for n, q in self._inv], np.float64)
        occupied = np.array([n != "air" for n, _ in self._inv])
        rgb = np.empty((3, self._h, self._w), np.uint8)
        rgb[0] = int(self._pos[0] * 8) % 256
        rgb[1] = int(self._pitch + 90) % 256
        rgb[2] = (int(self._yaw) + 7 * self._steps) % 256
        rgb[:, : self._h // 8, : int(self._w * self._life / 20)] = 255
        has_planks = self._planks_slot() is not None
        obs = {
            "rgb": rgb,
            "inventory": {"name": names, "quantity": quantity},
            "delta_inv": {k: list(v) for k, v in self._delta.items()},
            "equipment": {"name": np.array([names[self._mainhand]] + ["air"] * (_EQUIP - 1))},
            "life_stats": {"life": np.array([self._life]), "food": np.array([self._food]),
                           "oxygen": np.array([300.0])},
            "masks": {
                "action_type": np.array([True, True, occupied.any(), True, has_planks, occupied.any(),
                                         occupied.any(), occupied.any()]),
                "equip": occupied.copy(),
                "destroy": occupied & (np.arange(_SLOTS) % 2 == 1),
                "craft_smelt": np.array([has_planks and i % 3 != 2 for i in range(len(sim.ALL_CRAFT_SMELT_ITEMS))]),
            },
            "location_stats": {"pos": self._pos.copy(), "pitch": np.array([self._pitch]),
                               "yaw": np.array([self._yaw]), "biome_id": np.array([float(self._seed % 7)])},
        }
        self._prev_obs = obs
        return obs

    def step(self, action):
        a = np.asarray(action).astype(int)
        self._steps += 1
        self._delta = self._no_delta()
        heading = np.deg2rad(self._yaw)
        move = int(a[0] == 1) - int(a[0] == 2)
        strafe = int(a[1] == 1) - int(a[1] == 2)
        self._pos += 0.25 * np.array([move * np.cos(heading) - strafe * np.sin(heading), 0.0,
                                      move * np.sin(heading) + strafe * np.cos(heading)])
        if a[2] == 1:
            self._pos[1] += 0.5
        self._pitch = float(np.clip(self._pitch + (a[3] - 12) * 15, -90, 90))
        self._yaw = float((self._yaw + (a[4] - 12) * 15 + 180) % 360 - 180)
        reward = 0.0
        fn = a[5]
        if fn == 3 and self._rng.random() < min(1.0, 0.2 * self._break):
            item = _GATHER[int(self._rng.integers(len(_GATHER)))]
            if item == "wheat" and self._inv[self._mainhand][0] == "bucket":
                item = "milk_bucket"
            self._add(item, 1, "other")
        elif fn == 4:
            slot = self._planks_slot()
            if slot is not None and self._take(slot, 1, "craft"):
                self._add(sim.ALL_CRAFT_SMELT_ITEMS[a[6]], 1, "craft")
        elif fn == 5:
            self._mainhand = int(a[7]) if self._inv[a[7]][0] != "air" else self._mainhand
        elif fn in (6, 2):
            self._take(int(a[7]) if fn == 6 else self._mainhand, 1, "other")
        elif fn == 7:
            slot = int(a[7])
            if self._inv[slot][0] != "air":
                self._take(slot, self._inv[slot][1], "other")
        target = self._spec.get("target_names")
        if target and _spaced(target) in self._delta["inc_name_by_other"] + self._delta["inc_name_by_craft"]:
            reward = 1.0
        self._life -= float(self._rng.random() < 0.25) * float(self._rng.integers(1, 4))
        self._food = max(0.0, self._food - 0.05)
        dead = self._life <= 0
        timeout = self._steps >= MAX_STEPS
        info = {"TimeLimit.truncated": bool(timeout and not dead)} if timeout else {}
        return self._observe(), reward, bool(dead or timeout), info

    def render(self):
        return None

    def close(self):
        return None


def make(task_id, image_size=(160, 256), world_seed=None, fast_reset=True, break_speed_multiplier=1.0,
         start_position=None, **kwargs):
    if task_id not in tasks.ALL_TASKS_SPECS:
        raise ValueError(f"Unknown task {task_id}")
    spec = tasks.ALL_TASKS_SPECS[task_id]
    tasks.ALL_TASKS_SPECS[task_id] = dict(spec, __made__=True)  # MineDojo mutates its registry
    return _Sim(task_id, tuple(image_size), world_seed, break_speed_multiplier, start_position, spec)
