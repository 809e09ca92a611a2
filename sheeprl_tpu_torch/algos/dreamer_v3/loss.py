"""DreamerV3 world-model loss (counterpart of
``sheeprl_tpu/algos/dreamer_v3/loss.py``): observation, reward and continue
log-likelihoods plus KL-balanced dynamics/representation losses with free
nats, all in float32."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...distributions import Distribution, Independent, OneHotCategoricalStraightThrough, kl_divergence


def reconstruction_loss(
    po: Dict[str, Distribution],
    observations: Dict[str, torch.Tensor],
    pr: Distribution,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,  # [T, B, S, D]
    posteriors_logits: torch.Tensor,
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc: Optional[Distribution] = None,
    continue_targets: Optional[torch.Tensor] = None,
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    observation_loss = -sum(po[k].log_prob(observations[k]) for k in po)
    reward_loss = -pr.log_prob(rewards)
    dyn_loss = kl = kl_divergence(
        Independent(OneHotCategoricalStraightThrough(logits=posteriors_logits.detach()), 1),
        Independent(OneHotCategoricalStraightThrough(logits=priors_logits), 1),
    )
    free_nats = torch.full_like(dyn_loss, kl_free_nats)
    dyn_loss = kl_dynamic * torch.maximum(dyn_loss, free_nats)
    repr_loss = kl_divergence(
        Independent(OneHotCategoricalStraightThrough(logits=posteriors_logits), 1),
        Independent(OneHotCategoricalStraightThrough(logits=priors_logits.detach()), 1),
    )
    repr_loss = kl_representation * torch.maximum(repr_loss, free_nats)
    kl_loss = dyn_loss + repr_loss
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets)
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    return (
        rec_loss,
        kl.mean(),
        kl_loss.mean(),
        reward_loss.mean(),
        observation_loss.mean(),
        continue_loss.mean(),
    )
