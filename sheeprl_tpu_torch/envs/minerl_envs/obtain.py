"""The custom MineRL Obtain tasks (the port's own copy of
``sheeprl_tpu/envs/minerl_envs/obtain.py``).

Climb the tool ladder to a target item, rewarded per rung (once per item,
or at every collection in the dense variant), with GUI-free craft, smelt,
equip and place actions. The ladder and the item vocabularies are the
tables below; the spec classes read them. The spec sets no episode length
(the env pipeline's time limit truncates).

The spec classes subclass ``SimpleEmbodimentBase`` and are made at first
use (``classes()``, or this module's attributes).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Dict, List, Sequence, Tuple, Union

from . import backend

NONE, OTHER = "none", "other"

#: the inventory vocabulary every Obtain task observes
OBSERVED_ITEMS = (
    "dirt", "coal", "torch", "log", "planks", "stick", "crafting_table",
    "wooden_axe", "wooden_pickaxe", "stone", "cobblestone", "furnace",
    "stone_axe", "stone_pickaxe", "iron_ore", "iron_ingot", "iron_axe",
    "iron_pickaxe",
)
EQUIPABLE_ITEMS = (
    "air", "wooden_axe", "wooden_pickaxe", "stone_axe", "stone_pickaxe",
    "iron_axe", "iron_pickaxe",
)
PLACEABLE_BLOCKS = ("dirt", "stone", "cobblestone", "crafting_table", "furnace", "torch")
HAND_CRAFTABLE = ("torch", "stick", "planks", "crafting_table")
TABLE_CRAFTABLE = (
    "wooden_axe", "wooden_pickaxe", "stone_axe", "stone_pickaxe",
    "iron_axe", "iron_pickaxe", "furnace",
)
SMELTABLE = ("iron_ingot", "coal")

#: the tool ladder, (item, reward) a rung; diamond adds the last rung
_IRON_LADDER: Tuple[Tuple[str, float], ...] = (
    ("log", 1), ("planks", 2), ("stick", 4), ("crafting_table", 4),
    ("wooden_pickaxe", 8), ("cobblestone", 16), ("furnace", 32),
    ("stone_pickaxe", 32), ("iron_ore", 64), ("iron_ingot", 128),
    ("iron_pickaxe", 256),
)
_DIAMOND_LADDER = _IRON_LADDER + (("diamond", 1024),)


def _schedule(ladder: Sequence[Tuple[str, float]]) -> List[Dict[str, Union[str, int, float]]]:
    return [dict(type=item, amount=1, reward=reward) for item, reward in ladder]


def _camel(snake: str) -> str:
    return "".join(part.capitalize() for part in snake.split("_"))


def _ladder_of(schedule: List[Dict[str, Union[str, int, float]]]):
    return [(entry["type"], float(entry["reward"])) for entry in schedule]


@functools.lru_cache(maxsize=None)
def classes() -> SimpleNamespace:
    base = backend.classes().SimpleEmbodimentBase
    from minerl.herobraine.hero import handlers

    class CustomObtain(base):
        def __init__(
            self,
            target_item: str,
            dense: bool,
            reward_schedule: List[Dict[str, Union[str, int, float]]],
            *args,
            max_episode_steps=None,
            **kwargs,
        ):
            self.target_item = target_item
            self.dense = dense
            self.reward_schedule = reward_schedule
            name = f"CustomMineRLObtain{_camel(target_item)}{'Dense' if dense else ''}-v0"
            super().__init__(name, *args, max_episode_steps=max_episode_steps, **kwargs)

        def create_observables(self) -> list:
            return super().create_observables() + [
                handlers.FlatInventoryObservation(list(OBSERVED_ITEMS)),
                handlers.EquippedItemObservation(items=list(EQUIPABLE_ITEMS) + [OTHER], _default="air", _other=OTHER),
            ]

        def create_actionables(self) -> list:
            def choice(handler_cls, options):
                return handler_cls([NONE, *options], _other=NONE, _default=NONE)

            return super().create_actionables() + [
                choice(handlers.PlaceBlock, PLACEABLE_BLOCKS),
                choice(handlers.EquipAction, EQUIPABLE_ITEMS),
                choice(handlers.CraftAction, HAND_CRAFTABLE),
                choice(handlers.CraftNearbyAction, TABLE_CRAFTABLE),
                choice(handlers.SmeltItemNearby, SMELTABLE),
            ]

        def create_rewardables(self) -> list:
            once_or_every = handlers.RewardForCollectingItems if self.dense else handlers.RewardForCollectingItemsOnce
            return [once_or_every(self.reward_schedule or {self.target_item: 1})]

        def create_agent_handlers(self) -> list:
            return [handlers.AgentQuitFromPossessingItem([dict(type="diamond", amount=1)])]

        def create_server_world_generators(self) -> list:
            return [handlers.DefaultWorldGenerator(force_reset=True)]

        def create_server_quit_producers(self) -> list:
            return [handlers.ServerQuitWhenAnyAgentFinishes()]

        def create_server_decorators(self) -> list:
            return []

        def create_server_initial_conditions(self) -> list:
            return [
                handlers.TimeInitialCondition(start_time=6000, allow_passage_of_time=True),
                handlers.SpawningInitialCondition(allow_spawning=True),
            ]

        def is_from_folder(self, folder: str) -> bool:
            return folder == f"o_{self.target_item}"

        def get_docstring(self) -> str:
            when = "every time it collects" if self.dense else "once per first collection of"
            rungs = ", ".join(f"{item} (+{reward:g})" for item, reward in _ladder_of(self.reward_schedule))
            return f"Obtain {self.target_item}; rewarded {when} each ladder item: {rungs}."

        def determine_success_from_rewards(self, rewards: list) -> bool:
            # success: (almost) every rung of the ladder, at most 10% missing
            ladder_rewards = {entry["reward"] for entry in self.reward_schedule}
            seen = ladder_rewards.intersection(set(rewards))
            allowed_missing = round(len(self.reward_schedule) * 0.1)
            return len(seen) >= len(ladder_rewards) - allowed_missing

    class CustomObtainDiamond(CustomObtain):
        def __init__(self, dense: bool, *args, **kwargs):
            kwargs.pop("max_episode_steps", None)  # the time limit is the pipeline's
            super().__init__(*args, target_item="diamond", dense=dense, reward_schedule=_schedule(_DIAMOND_LADDER),
                             max_episode_steps=None, **kwargs)

        def is_from_folder(self, folder: str) -> bool:
            return folder == "o_dia"

    class CustomObtainIronPickaxe(CustomObtain):
        def __init__(self, dense: bool, *args, **kwargs):
            kwargs.pop("max_episode_steps", None)  # the time limit is the pipeline's
            super().__init__(*args, target_item="iron_pickaxe", dense=dense, reward_schedule=_schedule(_IRON_LADDER),
                             max_episode_steps=None, **kwargs)

        def create_agent_handlers(self) -> list:
            return [handlers.AgentQuitFromCraftingItem([dict(type="iron_pickaxe", amount=1)])]

        def is_from_folder(self, folder: str) -> bool:
            return folder == "o_iron"

    return SimpleNamespace(CustomObtain=CustomObtain, CustomObtainDiamond=CustomObtainDiamond,
                           CustomObtainIronPickaxe=CustomObtainIronPickaxe)


def __getattr__(name: str):
    if name in ("CustomObtain", "CustomObtainDiamond", "CustomObtainIronPickaxe"):
        return getattr(classes(), name)
    raise AttributeError(name)
