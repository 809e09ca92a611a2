"""DreamerV1 losses (counterpart of ``sheeprl_tpu/algos/dreamer_v1/loss.py``).

The world-model loss is Eq. 10 of arXiv:1912.01603: Gaussian
reconstruction and a Gaussian KL(posterior ‖ prior) held at least at the
free nats, without balancing. The continue term is the negative
log-likelihood (the JAX package's sign).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...distributions import Distribution, kl_divergence


def critic_loss(qv: Distribution, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """-E[discount · log q(λ)]."""
    return -torch.mean(discount * qv.log_prob(lambda_values))


def actor_loss(discounted_lambda_values: torch.Tensor) -> torch.Tensor:
    """-E[λ-values]."""
    return -torch.mean(discounted_lambda_values)


def reconstruction_loss(
    qo: Dict[str, Distribution],
    observations: Dict[str, torch.Tensor],
    qr: Distribution,
    rewards: torch.Tensor,
    posteriors_dist: Distribution,
    priors_dist: Distribution,
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    qc: Optional[Distribution] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, ...]:
    """(total, kl, state_loss, reward_loss, observation_loss, continue_loss)."""
    observation_loss = -sum(qo[k].log_prob(observations[k]).mean() for k in qo)
    reward_loss = -qr.log_prob(rewards).mean()
    kl = kl_divergence(posteriors_dist, priors_dist).mean()
    state_loss = torch.clamp_min(kl, kl_free_nats)
    if qc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -qc.log_prob(continue_targets).mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    return total, kl, state_loss, reward_loss, observation_loss, continue_loss
