"""PPO's per-algorithm contract (counterpart of
``sheeprl_tpu/algos/ppo/utils.py``): ``AGGREGATOR_KEYS``, ``prepare_obs`` and
the greedy ``test`` episode."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
}
MODELS_TO_REGISTER = {"agent"}


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (),
                num_envs: int = 1, device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """The host observations as the agent takes them, on ``device``: images
    stay uint8 ``[N, H, W, C]`` (the encoder scales them), vectors become
    f32 ``[N, -1]``."""
    out: Dict[str, torch.Tensor] = {}
    for k in cnn_keys:
        a = np.asarray(obs[k])
        out[k] = torch.as_tensor(a.reshape(num_envs, *a.shape[-3:])).to(device, non_blocking=True)
    for k in mlp_keys:
        out[k] = torch.as_tensor(np.asarray(obs[k], dtype=np.float32).reshape(num_envs, -1)).to(device)
    return out


def env_actions(actions: np.ndarray, is_continuous: bool, num_envs: int, multi: bool) -> np.ndarray:
    """The env's action layout of sampled ``[N, dims]`` actions."""
    if is_continuous or multi:
        return actions.reshape(num_envs, -1)
    return actions.reshape(num_envs)


@torch.no_grad()
def test(agent: Any, env: Any, cfg: Any, device: Any, logger: Any = None) -> float:
    """One greedy episode on ``env`` (prints ``Test - Reward: <r>``)."""
    from .agent import actions_and_log_probs

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    done = False
    cumulative_rew = 0.0
    obs, _ = env.reset(seed=int(cfg.seed))
    while not done:
        actor_out, _ = agent(prepare_obs(obs, cnn_keys, mlp_keys, 1, device))
        actions, _, _ = actions_and_log_probs(actor_out, agent.is_continuous, greedy=True)
        actions = actions.cpu().numpy()
        if agent.is_continuous:
            act = actions.reshape(env.action_space.shape)
        elif actions.shape[-1] > 1:
            act = actions.reshape(-1)
        else:
            act = actions.reshape(()).item()
        obs, reward, terminated, truncated, _ = env.step(act)
        done = bool(terminated or truncated)
        cumulative_rew += float(reward)
        if cfg.get("dry_run", False):
            done = True
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    print(f"Test - Reward: {cumulative_rew}", flush=True)
    env.close()
    return cumulative_rew
