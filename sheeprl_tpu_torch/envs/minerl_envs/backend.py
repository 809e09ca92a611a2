"""The base spec of the custom MineRL tasks (the port's own copy of
``sheeprl_tpu/envs/minerl_envs/backend.py``).

A small embodiment (POV camera, location and life observations, the eight
keyboard actions and the camera) with a block-break speed set in the
Malmo mission XML, which stock MineRL specs do not expose.

The classes subclass MineRL's ``Handler`` and ``EnvSpec``, so they are made
at first use (``classes()``, or this module's attributes) and never when
the module is imported; without MineRL that raises the JAX package's
``ModuleNotFoundError``.
"""
from __future__ import annotations

import functools
from abc import ABC
from types import SimpleNamespace
from typing import List

from ...utils import imports

#: the movement and interaction keys the simple embodiment exposes
KEYBOARD_ACTIONS = ("forward", "back", "left", "right", "jump", "sneak", "sprint", "attack")


@functools.lru_cache(maxsize=None)
def classes() -> SimpleNamespace:
    """``BreakSpeedMultiplier`` and ``SimpleEmbodimentBase``, on MineRL's
    classes."""
    imports.require(imports._IS_MINERL_AVAILABLE)
    from minerl.herobraine.env_spec import EnvSpec
    from minerl.herobraine.hero import handler, handlers
    from minerl.herobraine.hero.mc import INVERSE_KEYMAP

    class BreakSpeedMultiplier(handler.Handler):
        """The mission-XML knob that scales the block break speed: above 1,
        holding the attack button is unneeded."""

        def __init__(self, multiplier: float = 1.0):
            self.multiplier = multiplier

        def to_string(self) -> str:
            return f"break_speed({self.multiplier})"

        def xml_template(self) -> str:
            return "<BreakSpeedMultiplier>{{multiplier}}</BreakSpeedMultiplier>"

    class SimpleEmbodimentBase(EnvSpec, ABC):
        """POV, location and life stats; keyboard movement and the camera;
        the break speed. The task specs extend the lists."""

        def __init__(self, name, *args, resolution=(64, 64), break_speed: int = 100, **kwargs):
            self.resolution = resolution
            self.break_speed = break_speed
            super().__init__(name, *args, **kwargs)

        def create_agent_start(self) -> List[handler.Handler]:
            return [BreakSpeedMultiplier(self.break_speed)]

        def create_observables(self) -> list:
            return [
                handlers.POVObservation(self.resolution),
                handlers.ObservationFromCurrentLocation(),
                handlers.ObservationFromLifeStats(),
            ]

        def create_actionables(self) -> list:
            keyboard = [
                handlers.KeybasedCommandAction(key, mapping)
                for key, mapping in INVERSE_KEYMAP.items()
                if key in KEYBOARD_ACTIONS
            ]
            return keyboard + [handlers.CameraAction()]

        def create_monitors(self) -> list:
            return []

    return SimpleNamespace(BreakSpeedMultiplier=BreakSpeedMultiplier, SimpleEmbodimentBase=SimpleEmbodimentBase)


def __getattr__(name: str):
    if name in ("BreakSpeedMultiplier", "SimpleEmbodimentBase"):
        return getattr(classes(), name)
    raise AttributeError(name)
