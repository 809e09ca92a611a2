"""A2C losses (counterpart of ``sheeprl_tpu/algos/a2c/loss.py``): the policy
gradient with advantages and the value MSE."""
from __future__ import annotations

import torch


def policy_loss(logprobs: torch.Tensor, advantages: torch.Tensor, reduction: str = "sum") -> torch.Tensor:
    loss = -logprobs * advantages
    return loss.mean() if reduction == "mean" else loss.sum()


def value_loss(values: torch.Tensor, returns: torch.Tensor, reduction: str = "sum") -> torch.Tensor:
    loss = 0.5 * (values - returns).square()
    return loss.mean() if reduction == "mean" else loss.sum()
