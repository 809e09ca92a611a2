"""Optional-dependency gates (the port's own copy of
``sheeprl_tpu/utils/imports.py``).

Each flag is truthy when its suite's package can be found and otherwise
carries the message an adapter raises when it is built. ``find_spec``
imports nothing, so the port's modules import without any suite installed;
the flags are read once, when this module is imported.
"""
from __future__ import annotations

import importlib.util


class _Requirement:
    """Truthiness = the module can be found; ``str()`` = the install hint."""

    def __init__(self, module: str, hint: str):
        self._module = module
        self._hint = hint
        self._available = importlib.util.find_spec(module) is not None

    def __bool__(self) -> bool:
        return self._available

    def __str__(self) -> str:
        return f"Module '{self._module}' is not installed. {self._hint}"


def require(flag: _Requirement) -> None:
    """Raise ``ModuleNotFoundError(str(flag))`` where the suite is missing."""
    if not flag:
        raise ModuleNotFoundError(str(flag))


_IS_ALE_AVAILABLE = _Requirement("ale_py", "Install with `pip install ale-py gymnasium[atari]`.")
_IS_DMC_AVAILABLE = _Requirement("dm_control", "Install with `pip install dm_control`.")
_IS_CRAFTER_AVAILABLE = _Requirement("crafter", "Install with `pip install crafter`.")
_IS_DIAMBRA_AVAILABLE = _Requirement("diambra", "Install with `pip install diambra diambra-arena`.")
_IS_MINEDOJO_AVAILABLE = _Requirement("minedojo", "Install with `pip install minedojo`.")
_IS_MINERL_AVAILABLE = _Requirement("minerl", "Install with `pip install minerl==0.4.4`.")
_IS_SUPER_MARIO_BROS_AVAILABLE = _Requirement(
    "gym_super_mario_bros", "Install with `pip install gym-super-mario-bros`."
)
_IS_MLFLOW_AVAILABLE = _Requirement("mlflow", "Install with `pip install mlflow`.")
