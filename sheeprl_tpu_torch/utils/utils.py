"""Shared helpers: the replay-ratio controller (the port's own copy of
``Ratio`` from ``sheeprl_tpu/utils/utils.py``) and device selection."""
from __future__ import annotations

from typing import Any, Optional

import torch


class Ratio:
    """Replay-ratio controller: how many gradient steps to run for the env
    steps taken since the last update (the JAX package, sheeprl_tpu/utils/utils.py)."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._pretrain_steps = pretrain_steps
        self._ratio = ratio
        self._prev: Optional[float] = None

    def __call__(self, step: float) -> int:
        if self._ratio == 0:
            return 0
        if self._prev is None:
            self._prev = step
            repeats = int(self._pretrain_steps * self._ratio)
            if self._pretrain_steps > 0 and repeats == 0:
                repeats = 1
            return repeats
        repeats = round((step - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return int(repeats)


def get_device(cfg: Any) -> torch.device:
    """``fabric.accelerator``: auto | gpu | cuda run on the card and raise
    when there is none; cpu runs on the host. No silent fallback."""
    accelerator = str(cfg.select("fabric.accelerator", "auto")).lower()
    if int(cfg.select("fabric.devices", 1) or 1) != 1 or int(cfg.select("fabric.num_nodes", 1) or 1) != 1:
        raise NotImplementedError("the PyTorch port trains on one device: set fabric.devices=1")
    if accelerator == "cpu":
        return torch.device("cpu")
    if accelerator in ("auto", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"fabric.accelerator={accelerator} runs on a CUDA device and none is available "
                "(pass fabric.accelerator=cpu to run on the host)"
            )
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"fabric.accelerator must be auto | gpu | cuda | cpu, got {accelerator!r}")
