"""SAC's losses (counterpart of ``sheeprl_tpu/algos/sac/loss.py``)."""
from __future__ import annotations

import torch


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor) -> torch.Tensor:
    """The sum over the ``n`` critics of each one's MSE against the shared
    target. ``qf_values`` ``[n, B, 1]``, ``next_qf_value`` ``[B, 1]``."""
    return torch.square(qf_values - next_qf_value.unsqueeze(0)).mean(dim=(1, 2)).sum()


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, min_qf_values: torch.Tensor) -> torch.Tensor:
    return torch.mean(alpha * logprobs - min_qf_values)


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    return torch.mean(-log_alpha * (logprobs + target_entropy))
