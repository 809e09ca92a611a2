"""PPO losses (counterpart of ``sheeprl_tpu/algos/ppo/loss.py``): the clipped
surrogate, the value loss with optional clipping, and the entropy bonus."""
from __future__ import annotations

from typing import Union

import torch

Coef = Union[float, torch.Tensor]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    return loss.mean() if reduction == "mean" else loss.sum()


def policy_loss(logprobs: torch.Tensor, old_logprobs: torch.Tensor, advantages: torch.Tensor, clip_coef: Coef,
                reduction: str = "mean") -> torch.Tensor:
    ratio = torch.exp(logprobs - old_logprobs)
    pg1 = -advantages * ratio
    pg2 = -advantages * torch.clamp(ratio, 1.0 - clip_coef, 1.0 + clip_coef)
    return _reduce(torch.maximum(pg1, pg2), reduction)


def value_loss(new_values: torch.Tensor, old_values: torch.Tensor, returns: torch.Tensor, clip_coef: Coef,
               clip_vloss: bool, reduction: str = "mean") -> torch.Tensor:
    if clip_vloss:
        v_clipped = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
        loss = 0.5 * torch.maximum((new_values - returns).square(), (v_clipped - returns).square())
    else:
        loss = 0.5 * (new_values - returns).square()
    return _reduce(loss, reduction)


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return -_reduce(entropy, reduction)
