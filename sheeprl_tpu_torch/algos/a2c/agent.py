"""The A2C actor-critic (counterpart of ``sheeprl_tpu/algos/a2c/agent.py``):
PPO's agent on vector observations only."""
from __future__ import annotations

from typing import Any

import torch

from ..ppo.agent import PPOAgent, actions_and_log_probs
from ..ppo.agent import build_agent as _ppo_build_agent

__all__ = ["A2CAgent", "actions_and_log_probs", "build_agent"]

A2CAgent = PPOAgent


def build_agent(cfg: Any, obs_space: Any, action_space: Any, device: torch.device) -> PPOAgent:
    if cfg.algo.cnn_keys.encoder:
        raise ValueError(f"A2C only supports vector observations: got cnn keys {list(cfg.algo.cnn_keys.encoder)}")
    return _ppo_build_agent(cfg, obs_space, action_space, device)
