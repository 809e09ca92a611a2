"""``minerl.herobraine.hero.handlers`` of the stand-in: the handlers the
custom tasks compose, each holding its arguments. Observation and action
handlers give their space (``key``, ``space()``), as MineRL's do; the
reward, quit, world and server handlers are read by the stand-in's
simulator (``minerl.herobraine.env_spec``)."""
import numpy as np

from .. import spaces
from ..handler import Handler
from .translation import TranslationHandler


class POVObservation(TranslationHandler):
    key = "pov"

    def __init__(self, video_resolution, include_depth=False):
        super().__init__(video_resolution)
        self.resolution = tuple(video_resolution)

    def space(self):
        return spaces.Box(0, 255, self.resolution + (3,), np.uint8)


class ObservationFromCurrentLocation(TranslationHandler):
    key = "location_stats"

    def space(self):
        return spaces.Dict({k: spaces.Box(-1e6, 1e6, (1,), np.float64)
                            for k in ("xpos", "ypos", "zpos", "pitch", "yaw")})


class ObservationFromLifeStats(TranslationHandler):
    key = "life_stats"

    def space(self):
        return spaces.Dict({"life": spaces.Box(0, 20, (1,), np.float64), "food": spaces.Box(0, 20, (1,), np.float64),
                            "air": spaces.Box(0, 300, (1,), np.float64)})


class CompassObservation(TranslationHandler):
    key = "compass"

    def __init__(self, angle=True, distance=False):
        super().__init__(angle=angle, distance=distance)

    def space(self):
        return spaces.Dict({"angle": spaces.Box(-180.0, 180.0, (), np.float32)})


class FlatInventoryObservation(TranslationHandler):
    key = "inventory"

    def __init__(self, item_list, _other="other"):
        super().__init__(item_list)
        self.items = list(item_list)

    def space(self):
        return spaces.Dict({item: spaces.Box(0, 2304, (), np.int64) for item in self.items})


class EquippedItemObservation(TranslationHandler):
    key = "equipped_items"

    def __init__(self, items, mainhand=True, offhand=False, armor=False, _default="air", _other="other"):
        super().__init__(items)
        self.items = list(items)
        self.default = _default

    def space(self):
        return spaces.Dict({"mainhand": spaces.Dict({"type": spaces.Enum(*self.items, default=self.default)})})


class KeybasedCommandAction(TranslationHandler):
    def __init__(self, command, *keys):
        super().__init__(command, *keys)
        self.key = command

    def space(self):
        return spaces.Discrete(2)


class CameraAction(TranslationHandler):
    key = "camera"

    def space(self):
        return spaces.Box(-180.0, 180.0, (2,), np.float32)


class _ItemListAction(TranslationHandler):
    def __init__(self, items, _other="none", _default="none"):
        super().__init__(items)
        self.items = list(items)
        self.default = _default

    def space(self):
        return spaces.Enum(*self.items, default=self.default)


class PlaceBlock(_ItemListAction):
    key = "place"


class EquipAction(_ItemListAction):
    key = "equip"


class CraftAction(_ItemListAction):
    key = "craft"


class CraftNearbyAction(_ItemListAction):
    key = "nearbyCraft"


class SmeltItemNearby(_ItemListAction):
    key = "nearbySmelt"


class RewardForTouchingBlockType(Handler):
    def __init__(self, blocks):
        super().__init__(blocks)
        self.blocks = list(blocks)


class RewardForDistanceTraveledToCompassTarget(Handler):
    def __init__(self, reward_per_block, density="PER_TICK"):
        super().__init__(reward_per_block)
        self.reward_per_block = reward_per_block


class RewardForCollectingItems(Handler):
    def __init__(self, item_rewards):
        super().__init__(item_rewards)
        if isinstance(item_rewards, dict):
            item_rewards = [dict(type=k, amount=1, reward=v) for k, v in item_rewards.items()]
        self.reward_schedule = {r["type"]: float(r["reward"]) for r in item_rewards}


class RewardForCollectingItemsOnce(RewardForCollectingItems):
    pass


class AgentQuitFromTouchingBlockType(Handler):
    pass


class AgentQuitFromPossessingItem(Handler):
    def __init__(self, items):
        super().__init__(items)
        self.items = {i["type"]: i["amount"] for i in items}


class AgentQuitFromCraftingItem(AgentQuitFromPossessingItem):
    pass


class SimpleInventoryAgentStart(Handler):
    pass


class BiomeGenerator(Handler):
    def __init__(self, biome, force_reset=True):
        super().__init__(biome=biome, force_reset=force_reset)
        self.biome = biome


class DefaultWorldGenerator(Handler):
    pass


class ServerQuitWhenAnyAgentFinishes(Handler):
    pass


class NavigationDecorator(Handler):
    pass


class TimeInitialCondition(Handler):
    pass


class WeatherInitialCondition(Handler):
    pass


class SpawningInitialCondition(Handler):
    pass
