"""Recurrent PPO's per-algorithm contract (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/utils.py``): ``AGGREGATOR_KEYS``,
``prepare_obs`` with a leading sequence axis of 1, and the greedy ``test``
episode carrying the LSTM state."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..ppo.utils import AGGREGATOR_KEYS, MODELS_TO_REGISTER  # noqa: F401 - the same contract as PPO's

__all__ = ["AGGREGATOR_KEYS", "MODELS_TO_REGISTER", "one_hot_actions", "prepare_obs", "test"]


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (),
                num_envs: int = 1, device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """The host observations as ``[1, N, ...]`` tensors on ``device``
    (images uint8, vectors f32)."""
    out: Dict[str, torch.Tensor] = {}
    for k in cnn_keys:
        a = np.asarray(obs[k])
        out[k] = torch.as_tensor(a.reshape(1, num_envs, *a.shape[-3:])).to(device)
    for k in mlp_keys:
        out[k] = torch.as_tensor(np.asarray(obs[k], dtype=np.float32).reshape(1, num_envs, -1)).to(device)
    return out


def one_hot_actions(actions: np.ndarray, actions_dim: Sequence[int], is_continuous: bool) -> np.ndarray:
    """Sampled ``[N, dims]`` actions as the ``[N, sum(dims)]`` previous-action
    input: concatenated one-hots (the actions themselves if continuous)."""
    n = actions.shape[0]
    if is_continuous:
        return actions.reshape(n, -1).astype(np.float32)
    return np.concatenate([np.eye(d, dtype=np.float32)[actions[:, i]] for i, d in enumerate(actions_dim)], axis=-1)


@torch.no_grad()
def test(agent: Any, env: Any, cfg: Any, device: Any, logger: Any = None) -> float:
    """One greedy episode on ``env`` (prints ``Test - Reward: <r>``)."""
    from .agent import actions_and_log_probs

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    done = False
    cumulative_rew = 0.0
    obs, _ = env.reset(seed=int(cfg.seed))
    carry = agent.initial_states(1, device)
    prev_actions = torch.zeros(1, 1, sum(agent.actions_dim), device=device)
    is_first = torch.zeros(1, 1, 1, device=device)
    while not done:
        actor_out, _, carry = agent(prepare_obs(obs, cnn_keys, mlp_keys, 1, device), prev_actions, is_first, carry)
        actions, _, _ = actions_and_log_probs([a[0] for a in actor_out], agent.is_continuous, greedy=True)
        np_actions = actions.cpu().numpy()
        prev_actions = torch.as_tensor(one_hot_actions(np_actions, agent.actions_dim, agent.is_continuous),
                                       device=device).reshape(1, 1, -1)
        if agent.is_continuous:
            act = np_actions.reshape(env.action_space.shape)
        elif np_actions.shape[-1] > 1:
            act = np_actions.reshape(-1)
        else:
            act = np_actions.reshape(()).item()
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
