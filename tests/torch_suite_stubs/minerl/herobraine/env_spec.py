"""``minerl.herobraine.env_spec.EnvSpec`` (MineRL 0.4.4) of the stand-in,
and the simulator its ``make()`` returns.

``EnvSpec(name, max_episode_steps=None, reward_threshold=None)`` calls the
subclass's ``create_*`` methods when it is made and builds the observation
and action spaces (``Dict``s, keys sorted as gym sorts them) from the
observables' and actionables' handlers; ``make()`` returns a legacy env
(``reset()`` -> obs, ``step(action dict)`` -> ``(obs, reward, done, info)``,
``action_space.noop()``), under gym's ``TimeLimit`` where the spec has
``max_episode_steps``.

The simulator is not Minecraft: a deterministic toy (a generator seeded by
the spec's name and the episode number). Moving forward closes in on the
compass target (+``reward_per_block`` a block under the distance reward;
+100 and the end on reaching it); attacking gathers the next material the
held tool allows; crafting, smelting, placing and equipping move items of
the inventory; collecting or crafting a scheduled item pays its reward,
once or every time; damage is drawn from the generator, so an episode ends
at a death within a few dozen steps unless a quit handler ends it first.
"""
import abc
import zlib

import gym
import numpy as np

from .hero import handlers, spaces

_RECIPES = {  # item: (made, {ingredient: count}, needs)
    "planks": (4, {"log": 1}, None), "stick": (4, {"planks": 2}, None),
    "crafting_table": (1, {"planks": 4}, None), "torch": (4, {"stick": 1, "coal": 1}, None),
    "wooden_axe": (1, {"planks": 3, "stick": 2}, "crafting_table"),
    "wooden_pickaxe": (1, {"planks": 3, "stick": 2}, "crafting_table"),
    "stone_axe": (1, {"cobblestone": 3, "stick": 2}, "crafting_table"),
    "stone_pickaxe": (1, {"cobblestone": 3, "stick": 2}, "crafting_table"),
    "iron_axe": (1, {"iron_ingot": 3, "stick": 2}, "crafting_table"),
    "iron_pickaxe": (1, {"iron_ingot": 3, "stick": 2}, "crafting_table"),
    "furnace": (1, {"cobblestone": 8}, "crafting_table"),
    "iron_ingot": (1, {"iron_ore": 1, "coal": 1}, "furnace"), "coal": (1, {"log": 1}, "furnace"),
}
_TOOL_TIERS = (("iron_pickaxe", ("diamond", "iron_ore", "cobblestone", "coal")),
               ("stone_pickaxe", ("iron_ore", "cobblestone", "coal", "log")),
               ("wooden_pickaxe", ("cobblestone", "coal", "log", "dirt")))


class _SimEnv(gym.Env):
    def __init__(self, spec):
        self.spec = spec
        self.observation_space = spec.observation_space
        self.action_space = spec.action_space
        self._episode = 0
        self._seed = zlib.crc32(spec.name.encode())
        self._last_pov = None
        hs = spec.rewardables + spec.agent_handlers
        self._touch = next((h for h in hs if isinstance(h, handlers.RewardForTouchingBlockType)), None)
        self._per_block = next((h.reward_per_block for h in hs
                                if isinstance(h, handlers.RewardForDistanceTraveledToCompassTarget)), 0.0)
        self._collect = next((h for h in hs if isinstance(h, handlers.RewardForCollectingItems)), None)
        self._quit_items = {}
        for h in spec.agent_handlers:
            if isinstance(h, handlers.AgentQuitFromPossessingItem):
                self._quit_items.update(h.items)

    def reset(self):
        self._episode += 1
        self._rng = np.random.default_rng([self._seed, self._episode])
        self._backdrop = self._rng.integers(0, 256, (8, 3), dtype=np.uint8)
        self._distance = float(self._rng.integers(12, 40))
        self._angle = float(self._rng.uniform(-180, 180))
        self._inventory = {}
        self._collected = set()
        self._mainhand = "air"
        self._life, self._food = 20.0, 20.0
        self._pos = np.zeros(3)
        self._yaw = self._pitch = 0.0
        self._steps = 0
        return self._observe()

    def _observe(self):
        obs = {}
        for key, space in self.observation_space.spaces.items():
            if key == "pov":
                h, w, _ = space.shape
                pov = np.empty((h, w, 3), np.uint8)
                pov[...] = self._backdrop[(self._steps + np.arange(w) // 8) % 8][None]
                pov[: h // 8, : int(w * self._life / 20)] = 255
                self._last_pov = pov
                obs[key] = pov
            elif key == "inventory":
                obs[key] = {item: np.array(self._inventory.get(item, 0)) for item in space.spaces}
            elif key == "compass":
                obs[key] = {"angle": np.array(self._angle, np.float32)}
            elif key == "life_stats":
                obs[key] = {"life": np.array([self._life]), "food": np.array([self._food]), "air": np.array([300.0])}
            elif key == "location_stats":
                obs[key] = {"xpos": self._pos[:1].copy(), "ypos": self._pos[1:2].copy(), "zpos": self._pos[2:].copy(),
                            "pitch": np.array([self._pitch]), "yaw": np.array([self._yaw])}
            elif key == "equipped_items":
                obs[key] = {"mainhand": {"type": self._mainhand, "damage": np.array(0), "maxDamage": np.array(0)}}
        return obs

    def _gain(self, item, count, gained):
        self._inventory[item] = self._inventory.get(item, 0) + count
        gained.append(item)

    def _craft(self, item, gained):
        if item not in _RECIPES:
            return
        made, needs, station = _RECIPES[item]
        if station and not self._inventory.get(station):
            return
        if all(self._inventory.get(k, 0) >= n for k, n in needs.items()):
            for k, n in needs.items():
                self._inventory[k] -= n
            self._gain(item, made, gained)

    def step(self, action):
        self._steps += 1
        gained = []
        reward = 0.0
        cam = np.asarray(action.get("camera", np.zeros(2)), np.float64)
        self._pitch = float(np.clip(self._pitch + cam[0], -90, 90))
        self._yaw += float(cam[1])
        self._angle = float((self._angle - cam[1] + 180) % 360 - 180)
        if action.get("forward", 0) and not action.get("back", 0):
            step = (1.5 if action.get("sprint", 0) else 1.0) * np.cos(np.deg2rad(self._angle))
            before = self._distance
            self._distance = max(0.0, self._distance - step)
            reward += self._per_block * (before - self._distance)
            self._pos[0] += step
        if action.get("jump", 0):
            self._pos[1] += 1.0
        if action.get("attack", 0) and self._rng.random() < 0.4:
            tier = next((mats for tool, mats in _TOOL_TIERS if self._mainhand == tool), ("log", "dirt", "sand"))
            self._gain(tier[int(self._rng.integers(len(tier)))], 1, gained)
        for key in ("craft", "nearbyCraft", "nearbySmelt"):
            choice = action.get(key, "none")
            if choice not in ("none", 0):
                self._craft(str(choice), gained)
        place = action.get("place", "none")
        if place not in ("none", 0) and self._inventory.get(str(place), 0) > 0:
            self._inventory[str(place)] -= 1
        equip = action.get("equip", "none")
        if equip not in ("none", 0):
            self._mainhand = str(equip) if equip == "air" or self._inventory.get(str(equip), 0) > 0 else self._mainhand
        if self._collect is not None:
            once = isinstance(self._collect, handlers.RewardForCollectingItemsOnce)
            for item in gained:
                if item in self._collect.reward_schedule and not (once and item in self._collected):
                    reward += self._collect.reward_schedule[item]
                    self._collected.add(item)
        done = False
        if self._touch is not None and self._distance <= 0:
            reward += float(self._touch.blocks[0]["reward"])
            done = True
        if any(self._inventory.get(item, 0) >= n for item, n in self._quit_items.items()):
            done = True
        self._life -= float(self._rng.random() < 0.2) * float(self._rng.integers(1, 4))
        self._food = max(0.0, self._food - 0.1)
        done = done or self._life <= 0
        return self._observe(), reward, done, {}

    def render(self, mode="human"):
        return self._last_pov


class EnvSpec(abc.ABC):
    def __init__(self, name, max_episode_steps=None, reward_threshold=None):
        self.name = name
        self.max_episode_steps = max_episode_steps
        self.reward_threshold = reward_threshold
        self.agent_handlers = self.create_agent_handlers()
        self.agent_start = self.create_agent_start()
        self.observables = self.create_observables()
        self.actionables = self.create_actionables()
        self.rewardables = self.create_rewardables()
        self.monitors = self.create_monitors()
        self.server_world_generators = self.create_server_world_generators()
        self.server_quit_producers = self.create_server_quit_producers()
        self.server_decorators = self.create_server_decorators()
        self.server_initial_conditions = self.create_server_initial_conditions()
        self.observation_space = spaces.Dict({h.key: h.space() for h in self.observables})
        self.action_space = spaces.Dict({h.key: h.space() for h in self.actionables})

    def make(self, **kwargs):
        env = _SimEnv(self)
        return gym.TimeLimit(env, self.max_episode_steps) if self.max_episode_steps else env

    @abc.abstractmethod
    def create_observables(self): ...

    @abc.abstractmethod
    def create_actionables(self): ...

    @abc.abstractmethod
    def create_rewardables(self): ...

    @abc.abstractmethod
    def create_agent_start(self): ...

    @abc.abstractmethod
    def create_agent_handlers(self): ...

    @abc.abstractmethod
    def create_monitors(self): ...

    @abc.abstractmethod
    def create_server_world_generators(self): ...

    @abc.abstractmethod
    def create_server_quit_producers(self): ...

    @abc.abstractmethod
    def create_server_decorators(self): ...

    @abc.abstractmethod
    def create_server_initial_conditions(self): ...

    @abc.abstractmethod
    def determine_success_from_rewards(self, rewards): ...

    @abc.abstractmethod
    def is_from_folder(self, folder): ...

    @abc.abstractmethod
    def get_docstring(self): ...
