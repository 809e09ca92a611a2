"""DreamerV2 losses (counterpart of ``sheeprl_tpu/algos/dreamer_v2/loss.py``).

KL balancing (Eq. 2 of arXiv:2010.02193): α·KL(sg(post)‖prior) +
(1-α)·KL(post‖sg(prior)), each side held at least ``kl_free_nats`` after
averaging (``kl_free_avg``) or per element. Everything in f32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...distributions import Distribution, Independent, OneHotCategoricalStraightThrough, kl_divergence


def _categorical(logits: torch.Tensor) -> Independent:
    return Independent(OneHotCategoricalStraightThrough(logits=logits), 1)


def reconstruction_loss(
    po: Dict[str, Distribution],
    observations: Dict[str, torch.Tensor],
    pr: Distribution,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,  # [T, B, S, D]
    posteriors_logits: torch.Tensor,  # [T, B, S, D]
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    pc: Optional[Distribution] = None,
    continue_targets: Optional[torch.Tensor] = None,
    discount_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """(reconstruction_loss, kl, kl_loss, reward_loss, observation_loss,
    continue_loss); ``kl`` is per element [T, B]."""
    observation_loss = -sum(po[k].log_prob(observations[k]).mean() for k in po)
    reward_loss = -pr.log_prob(rewards).mean()
    lhs = kl = kl_divergence(_categorical(posteriors_logits.detach()), _categorical(priors_logits))
    rhs = kl_divergence(_categorical(posteriors_logits), _categorical(priors_logits.detach()))
    if kl_free_avg:
        loss_lhs = torch.clamp_min(lhs.mean(), kl_free_nats)
        loss_rhs = torch.clamp_min(rhs.mean(), kl_free_nats)
    else:
        loss_lhs = torch.clamp_min(lhs, kl_free_nats).mean()
        loss_rhs = torch.clamp_min(rhs, kl_free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    if pc is not None and continue_targets is not None:
        continue_loss = discount_scale_factor * -pc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    return rec_loss, kl, kl_loss, reward_loss, observation_loss, continue_loss
