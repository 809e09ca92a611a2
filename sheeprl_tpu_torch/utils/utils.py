"""Shared helpers (the port's own copies from ``sheeprl_tpu/utils/utils.py``):
the replay-ratio controller, linear annealing, the wall-clock stopper, config
saving, and device selection."""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, Optional

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

    def peek(self, step: float) -> int:
        """What ``__call__(step)`` would return, without consuming the budget."""
        if self._ratio == 0:
            return 0
        if self._prev is None:
            repeats = int(self._pretrain_steps * self._ratio)
            if self._pretrain_steps > 0 and repeats == 0:
                repeats = 1
            return repeats
        return int(round((step - self._prev) * self._ratio))

    def state_dict(self) -> Dict[str, Any]:
        return {"_ratio": self._ratio, "_prev": self._prev, "_pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state: Dict[str, Any]) -> "Ratio":
        self._ratio = float(state["_ratio"])
        self._prev = state["_prev"]
        self._pretrain_steps = int(state["_pretrain_steps"])
        return self


def linear_annealing(initial: float, step: int, total_steps: int, final: float = 0.0) -> float:
    """The on-policy loops' clip-coefficient and entropy annealing: from
    ``initial`` at step 0 to ``final`` at ``total_steps``."""
    frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
    return initial + frac * (final - initial)


class WallClockStopper:
    """``algo.max_wall_time_s``: stop training cleanly at a step boundary
    once the wall-clock budget is spent (-1 = never)."""

    def __init__(self, cfg: Any):
        self.max_s = float(cfg.select("algo.max_wall_time_s", -1) or -1)
        self._t0 = time.perf_counter()

    def expired(self, policy_step: int, total_steps: int) -> bool:
        if self.max_s <= 0:
            return False
        elapsed = time.perf_counter() - self._t0
        if elapsed <= self.max_s:
            return False
        print(f"[wall-time] stopping at step {policy_step}/{total_steps} after {elapsed:.1f}s", file=sys.stderr,
              flush=True)
        return True


def wall_cap_reached(
    wall: WallClockStopper, policy_step: int, total_steps: int, ckpt, state_fn, cfg, save: bool = True
) -> bool:
    """The wall-cap stop policy of the training loops: when the budget is
    spent, write the final checkpoint (iff ``checkpoint.save_last``) and tell
    the caller to break. ``save=False`` leaves the final checkpoint to the
    caller (the overlapped loop saves after the player has joined)."""
    if not wall.expired(policy_step, total_steps):
        return False
    if save and cfg.checkpoint.save_last:
        ckpt.save(policy_step, state_fn())
    return True


def save_configs(cfg: Any, log_dir: str) -> None:
    from ..config import save_config

    save_config(cfg, f"{log_dir}/config.yaml")


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
