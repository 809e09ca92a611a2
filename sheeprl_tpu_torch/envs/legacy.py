"""The base of the adapters over pre-gymnasium envs (the port's own copy of
``sheeprl_tpu/envs/legacy.py``).

Crafter and nes_py (Super Mario Bros) predate the gymnasium API: 4-tuple
steps, no ``seed=`` on reset. The legacy env is held as a member of an env
with the gymnasium interface on the port's own spaces (``envs/spaces.py``),
as ``envs/dmc.py`` holds dm_control's; each adapter supplies only its
suite's dict observation and terminated/truncated split. No gymnasium is
imported: the card's machine has none.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from . import spaces


def box_like(legacy_space: Any, key: str = "rgb") -> spaces.Dict:
    """``Dict({key: Box})`` with a legacy Box-like space's low, high, shape
    and dtype (any object with those four attributes)."""
    return spaces.Dict(
        {key: spaces.Box(legacy_space.low, legacy_space.high, legacy_space.shape, legacy_space.dtype)}
    )


class LegacyEnvAdapter:
    """Holds a legacy env: public attributes it does not define are the
    held env's; ``render_mode`` is settable (a video recorder sets it);
    ``render`` and ``close`` pass through. Subclasses set ``self.env`` and
    the spaces and implement ``step``/``reset``."""

    obs_key = "rgb"
    metadata: Dict[str, Any] = {}

    def __init__(self, env: Any, render_mode: str = "rgb_array") -> None:
        self.env = env
        self._render_mode = render_mode

    def __getattr__(self, name: str):
        # only public attributes delegate: a private lookup fails fast, which
        # keeps pickling honest
        if name.startswith("_") or name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def render_mode(self) -> Optional[str]:
        return self._render_mode

    @render_mode.setter
    def render_mode(self, value: str) -> None:
        self._render_mode = value

    @property
    def unwrapped(self) -> "LegacyEnvAdapter":
        return self

    def _dict_obs(self, frame: np.ndarray) -> Dict[str, np.ndarray]:
        return {self.obs_key: frame}

    def render(self):
        return self.env.render()

    def close(self) -> None:
        closer = getattr(self.env, "close", None)
        if callable(closer):
            closer()
