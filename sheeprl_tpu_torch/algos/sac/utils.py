"""SAC's per-algorithm contract (counterpart of
``sheeprl_tpu/algos/sac/utils.py``): ``AGGREGATOR_KEYS``, ``flatten_obs``,
``prepare_obs`` and the greedy ``test`` episode."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
}
MODELS_TO_REGISTER = {"agent"}


def flatten_obs(obs: Dict[str, np.ndarray], mlp_keys: Sequence[str], num_envs: int) -> np.ndarray:
    """The vector keys concatenated into one f32 ``[N, D]`` array."""
    return np.concatenate([np.asarray(obs[k], np.float32).reshape(num_envs, -1) for k in mlp_keys], axis=-1)


def prepare_obs(obs: Dict[str, np.ndarray], mlp_keys: Sequence[str], num_envs: int = 1,
                device: Any = "cpu") -> torch.Tensor:
    """``flatten_obs`` as a tensor on ``device``."""
    return torch.from_numpy(flatten_obs(obs, mlp_keys, num_envs)).to(device)


@torch.no_grad()
def test(actor: Any, env: Any, cfg: Any, device: Any, logger: Any = None) -> float:
    """One greedy (mean-action) episode on ``env`` (prints ``Test - Reward:
    <r>``)."""
    from .agent import sample_actions

    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    done = False
    cumulative_rew = 0.0
    obs, _ = env.reset(seed=int(cfg.seed))
    while not done:
        mean, log_std = actor(prepare_obs(obs, mlp_keys, 1, device))
        actions, _ = sample_actions(actor, mean, log_std, greedy=True)
        obs, reward, terminated, truncated, _ = env.step(actions.cpu().numpy().reshape(env.action_space.shape))
        done = bool(terminated or truncated)
        cumulative_rew += float(reward)
        if cfg.get("dry_run", False):
            done = True
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    print(f"Test - Reward: {cumulative_rew}", flush=True)
    env.close()
    return cumulative_rew
