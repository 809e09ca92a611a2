"""DreamerV2 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v2/utils.py``):
the logged metrics, the discrete stochastic state, the TD(λ) targets with a
bootstrap, and (shared with DreamerV3) the observation shaping and the
greedy test episode."""
from __future__ import annotations

from typing import Optional

import torch

from ..dreamer_v3.agent import compute_stochastic_state  # noqa: F401 - the discrete sampler DV2 shares
from ..dreamer_v3.utils import normalize_obs, prepare_obs, test  # noqa: F401 - shared with DreamerV3

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic"}


def compute_lambda_values(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor,
                          bootstrap: Optional[torch.Tensor] = None, lmbda: float = 0.95) -> torch.Tensor:
    """TD(λ) targets with an explicit bootstrap value, all [H, B, 1]:
    ``agg_t = r_t + c_t·(1-λ)·v_{t+1} + c_t·λ·agg_{t+1}`` from
    ``agg_H = bootstrap`` (``v_H`` the bootstrap too)."""
    if bootstrap is None:
        bootstrap = torch.zeros_like(values[-1])
    next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
    inputs = rewards + continues * next_values * (1 - lmbda)
    agg = bootstrap
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        agg = inputs[t] + continues[t] * lmbda * agg
        out.append(agg)
    return torch.stack(out[::-1])
