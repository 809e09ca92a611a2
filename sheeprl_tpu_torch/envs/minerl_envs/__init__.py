"""The custom MineRL task specs (the port's own copy of
``sheeprl_tpu/envs/minerl_envs/``): Navigate[Extreme][Dense] and
Obtain{Diamond,IronPickaxe}[Dense] with an adjustable break speed.

The specs subclass MineRL's classes, so they are made at first use:
``custom_tasks()`` (the ``CUSTOM_TASKS`` map) or any of this package's
spec names. Without MineRL that raises the JAX package's
``ModuleNotFoundError``; importing the package does not.
"""
from __future__ import annotations

import functools
from typing import Dict

from . import backend, navigate, obtain
from .navigate import NAVIGATE_STEPS

_SPECS = {"BreakSpeedMultiplier": backend, "SimpleEmbodimentBase": backend, "CustomNavigate": navigate,
          "CustomObtain": obtain, "CustomObtainDiamond": obtain, "CustomObtainIronPickaxe": obtain}


@functools.lru_cache(maxsize=None)
def custom_tasks() -> Dict[str, type]:
    """``env.id`` (lowercased) -> spec class, read by ``envs/minerl.py``."""
    return {
        "custom_navigate": navigate.classes().CustomNavigate,
        "custom_obtain_diamond": obtain.classes().CustomObtainDiamond,
        "custom_obtain_iron_pickaxe": obtain.classes().CustomObtainIronPickaxe,
    }


def __getattr__(name: str):
    if name == "CUSTOM_TASKS":
        return custom_tasks()
    if name in _SPECS:
        return getattr(_SPECS[name].classes(), name)
    raise AttributeError(name)


__all__ = ["BreakSpeedMultiplier", "SimpleEmbodimentBase", "CustomNavigate", "CustomObtain", "CustomObtainDiamond",
           "CustomObtainIronPickaxe", "CUSTOM_TASKS", "NAVIGATE_STEPS", "custom_tasks"]
