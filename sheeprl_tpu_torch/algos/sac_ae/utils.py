"""SAC-AE's per-algorithm contract (counterpart of
``sheeprl_tpu/algos/sac_ae/utils.py``): ``AGGREGATOR_KEYS``,
``preprocess_obs`` (the reconstruction target), ``prepare_obs`` and the
greedy ``test`` episode."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
    "Loss/reconstruction_loss",
}
MODELS_TO_REGISTER = {"agent", "encoder", "decoder"}


def preprocess_obs(obs: torch.Tensor, bits: int = 8, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bit-depth reduction and dequantisation noise
    (https://arxiv.org/abs/1807.03039): ``floor(obs / 2^(8-bits)) / 2^bits``
    plus ``noise / 2^bits`` (``noise`` uniform in [0, 1), pre-drawn, of
    ``obs``'s shape), less 0.5."""
    bins = 2 ** bits
    obs = obs.float()
    if bits < 8:
        obs = torch.floor(obs / 2 ** (8 - bits))
    obs = obs / bins
    if noise is not None:
        obs = obs + noise / bins
    return obs - 0.5


def normalize_obs(obs: Dict[str, torch.Tensor], cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                  prefix: str = "") -> Dict[str, torch.Tensor]:
    """The encoder's input from a batch's ``<prefix><key>`` entries: images
    as f32 in [0, 1], vectors as f32."""
    out = {k: obs[prefix + k].float() / 255.0 for k in cnn_keys}
    out.update({k: obs[prefix + k].float() for k in mlp_keys})
    return out


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], mlp_keys: Sequence[str], num_envs: int,
                device: Any) -> Dict[str, torch.Tensor]:
    """The host observations as the encoder takes them, on ``device``
    (the JAX package's ``prepare_obs_np`` with ``normalize=True``)."""
    out: Dict[str, torch.Tensor] = {}
    for k in cnn_keys:
        a = np.asarray(obs[k])
        out[k] = torch.as_tensor(a.reshape(num_envs, *a.shape[-3:])).to(device).float() / 255.0
    for k in mlp_keys:
        out[k] = torch.as_tensor(np.asarray(obs[k], np.float32).reshape(num_envs, -1)).to(device)
    return out


@torch.no_grad()
def test(agent: Any, env: Any, cfg: Any, device: Any, logger: Any = None) -> float:
    """One greedy episode with ``agent``'s encoder and actor (prints ``Test -
    Reward: <r>``)."""
    from ..sac.agent import sample_actions

    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    done = False
    cumulative_rew = 0.0
    obs, _ = env.reset(seed=int(cfg.seed))
    while not done:
        mean, log_std = agent.actor(agent.encoder(prepare_obs(obs, cnn_keys, mlp_keys, 1, device)))
        actions, _ = sample_actions(agent.actor, mean, log_std, greedy=True)
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
