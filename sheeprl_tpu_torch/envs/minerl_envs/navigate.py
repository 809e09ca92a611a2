"""The custom MineRL Navigate task (the port's own copy of
``sheeprl_tpu/envs/minerl_envs/navigate.py``).

Reach a diamond block the compass points at: +100 on touching it and, in
the dense variant, +1 a block of progress; the extreme variant is in the
extreme-hills biome. The spec sets no episode length: MineRL cannot tell
terminated from truncated, so the time limit is the env pipeline's, where
the two flags stay apart.

``CustomNavigate`` subclasses ``SimpleEmbodimentBase`` and is made at first
use (``classes()``, or this module's attribute).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import List

from . import backend

NAVIGATE_STEPS = 6000
_TARGET_BLOCK = "diamond_block"
_EXTREME_BIOME = 3  # extreme hills


@functools.lru_cache(maxsize=None)
def classes() -> SimpleNamespace:
    base = backend.classes().SimpleEmbodimentBase
    import minerl.herobraine.hero.handlers as handlers

    class CustomNavigate(base):
        def __init__(self, dense: bool, extreme: bool, *args, **kwargs):
            self.dense, self.extreme = dense, extreme
            variant = ("Extreme" if extreme else "") + ("Dense" if dense else "")
            # the time limit is the env pipeline's (see the module docstring)
            kwargs.pop("max_episode_steps", None)
            super().__init__(f"CustomMineRLNavigate{variant}-v0", *args, max_episode_steps=None, **kwargs)

        def is_from_folder(self, folder: str) -> bool:
            return folder == ("navigateextreme" if self.extreme else "navigate")

        def create_observables(self) -> list:
            return super().create_observables() + [
                handlers.CompassObservation(angle=True, distance=False),
                handlers.FlatInventoryObservation(["dirt"]),
            ]

        def create_actionables(self) -> list:
            place_dirt = handlers.PlaceBlock(["none", "dirt"], _other="none", _default="none")
            return super().create_actionables() + [place_dirt]

        def create_rewardables(self) -> list:
            goal = handlers.RewardForTouchingBlockType(
                [{"type": _TARGET_BLOCK, "behaviour": "onceOnly", "reward": 100.0}]
            )
            shaping = [handlers.RewardForDistanceTraveledToCompassTarget(reward_per_block=1.0)] if self.dense else []
            return [goal] + shaping

        def create_agent_start(self) -> list:
            compass = handlers.SimpleInventoryAgentStart([dict(type="compass", quantity="1")])
            return super().create_agent_start() + [compass]

        def create_agent_handlers(self) -> list:
            return [handlers.AgentQuitFromTouchingBlockType([_TARGET_BLOCK])]

        def create_server_world_generators(self) -> list:
            if self.extreme:
                return [handlers.BiomeGenerator(biome=_EXTREME_BIOME, force_reset=True)]
            return [handlers.DefaultWorldGenerator(force_reset=True)]

        def create_server_quit_producers(self) -> list:
            return [handlers.ServerQuitWhenAnyAgentFinishes()]

        def create_server_decorators(self) -> list:
            return [
                handlers.NavigationDecorator(
                    max_randomized_radius=64,
                    min_randomized_radius=64,
                    block=_TARGET_BLOCK,
                    placement="surface",
                    max_radius=8,
                    min_radius=0,
                    max_randomized_distance=8,
                    min_randomized_distance=0,
                    randomize_compass_location=True,
                )
            ]

        def create_server_initial_conditions(self) -> list:
            return [
                handlers.TimeInitialCondition(allow_passage_of_time=False, start_time=6000),
                handlers.WeatherInitialCondition("clear"),
                handlers.SpawningInitialCondition("false"),
            ]

        def get_docstring(self) -> str:
            return (
                "Reach the diamond block indicated by the compass (+100 once on "
                "touch" + (", +1 per block of compass progress" if self.dense else "") + ")."
            )

        def determine_success_from_rewards(self, rewards: List[float]) -> bool:
            threshold = 100.0 + (60.0 if self.dense else 0.0)
            return sum(rewards) >= threshold

    return SimpleNamespace(CustomNavigate=CustomNavigate)


def __getattr__(name: str):
    if name == "CustomNavigate":
        return classes().CustomNavigate
    raise AttributeError(name)
