"""Return estimators as reverse loops over time.

Counterpart of ``sheeprl_tpu/ops/returns.py`` (reverse ``lax.scan``s there).
Time is axis 0 throughout ([T, B, ...] layout).
"""
from __future__ import annotations

from typing import Tuple

import torch


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    num_steps: int,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation. rewards/values/dones [T, B, 1],
    next_value [B, 1]. Returns (returns, advantages), both [T, B, 1]."""
    del num_steps
    not_dones = 1.0 - dones
    next_values = torch.cat([values[1:], next_value[None]], dim=0)
    deltas = rewards + gamma * next_values * not_dones - values
    carry = torch.zeros_like(next_value)
    advantages = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * gae_lambda * not_dones[t] * carry
        advantages.append(carry)
    advantages = torch.stack(advantages[::-1], dim=0)
    return advantages + values, advantages


def lambda_values(
    rewards: torch.Tensor,
    values: torch.Tensor,
    continues: torch.Tensor,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """Dreamer TD(λ) targets. rewards/values/continues: [T, B, 1], where
    ``continues`` already includes the discount factor γ. The recursion
    bootstraps from values[-1]."""
    interm = rewards + continues * values * (1 - lmbda)
    carry = values[-1]
    lvs = []
    for t in range(interm.shape[0] - 1, -1, -1):
        carry = interm[t] + continues[t] * lmbda * carry
        lvs.append(carry)
    return torch.stack(lvs[::-1], dim=0)


def nstep_returns(
    rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor, gamma: float
) -> torch.Tensor:
    """Discounted bootstrap returns."""
    not_dones = 1.0 - dones
    carry = values[-1]
    rets = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + gamma * not_dones[t] * carry
        rets.append(carry)
    return torch.stack(rets[::-1], dim=0)
