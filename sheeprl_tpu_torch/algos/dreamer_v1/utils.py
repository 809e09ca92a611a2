"""DreamerV1 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v1/utils.py``):
the logged metrics and DreamerV1's TD(λ) targets; the observation shaping
and the greedy test episode are DreamerV2's."""
from __future__ import annotations

import torch

from ..dreamer_v2.utils import normalize_obs, prepare_obs, test  # noqa: F401 - shared with DreamerV2

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
    "State/post_entropy",
    "State/prior_entropy",
    "State/kl",
    "Params/exploration_amount",
}
MODELS_TO_REGISTER = {"world_model", "actor", "critic"}


def compute_lambda_values(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor,
                          last_values: torch.Tensor, horizon: int = 15, lmbda: float = 0.95) -> torch.Tensor:
    """TD(λ) targets of DreamerV1, ``horizon - 1`` of them from [H, B, 1]
    inputs: the next value is ``values[t+1]·(1-λ)`` except at the last step,
    which bootstraps with the unscaled ``last_values`` [B, 1];
    ``agg_t = r_t + c_t·next_t + λ·c_t·agg_{t+1}`` from ``agg = 0``."""
    next_values = torch.cat([values[1 : horizon - 1] * (1 - lmbda), last_values[None]], dim=0)
    deltas = rewards[: horizon - 1] + next_values * continues[: horizon - 1]
    agg = torch.zeros_like(last_values)
    out = []
    for t in range(horizon - 2, -1, -1):
        agg = deltas[t] + lmbda * continues[t] * agg
        out.append(agg)
    return torch.stack(out[::-1])
