"""Stand-in for MineRL 0.4.4 (``import minerl``; ``minerl.herobraine``).

Mirrors: importing ``minerl`` registers its environments with the legacy
``gym`` (here ``MineRLNavigateDense-v0``, a compass navigation task of
``NAVIGATE_STEPS`` steps under gym's ``TimeLimit``); ``minerl.herobraine``
holds ``env_spec.EnvSpec``, whose ``make()`` builds an env from the spec's
handlers, and ``hero.{handler, handlers, mc, spaces}``: the handler classes
and spaces (``Enum`` with ``values``, ``Dict.noop()``) that the custom tasks
subclass and compose, ``mc.ALL_ITEMS`` and ``mc.INVERSE_KEYMAP``. The
simulation is a deterministic toy (see ``herobraine/env_spec.py``).
"""
import gym

from .herobraine import env_spec  # noqa: F401
from .herobraine.hero import handlers, mc

__version__ = "0.4.4-stand-in"
NAVIGATE_STEPS = 6000


class _Navigate(env_spec.EnvSpec):
    def create_observables(self):
        return [handlers.POVObservation((64, 64)), handlers.CompassObservation(angle=True),
                handlers.FlatInventoryObservation(["dirt"])]

    def create_actionables(self):
        keys = [handlers.KeybasedCommandAction(k, v) for k, v in mc.INVERSE_KEYMAP.items()
                if k in ("forward", "back", "left", "right", "jump", "sneak", "sprint", "attack")]
        return keys + [handlers.CameraAction(), handlers.PlaceBlock(["none", "dirt"])]

    def create_rewardables(self):
        return [handlers.RewardForTouchingBlockType([{"type": "diamond_block", "behaviour": "onceOnly",
                                                      "reward": 100.0}]),
                handlers.RewardForDistanceTraveledToCompassTarget(reward_per_block=1.0)]

    def create_agent_handlers(self):
        return [handlers.AgentQuitFromTouchingBlockType(["diamond_block"])]

    def create_agent_start(self):
        return []

    create_monitors = create_server_world_generators = create_server_quit_producers = create_agent_start
    create_server_decorators = create_server_initial_conditions = create_agent_start

    def determine_success_from_rewards(self, rewards):
        return sum(rewards) >= 160.0

    def is_from_folder(self, folder):
        return folder == "navigate"

    def get_docstring(self):
        return "Navigate to the diamond block."


gym.register("MineRLNavigateDense-v0", lambda: _Navigate("MineRLNavigateDense-v0").make(),
             max_episode_steps=NAVIGATE_STEPS)
