"""Plan2Explore-DV1 agent (counterpart of ``sheeprl_tpu/algos/p2e_dv1/agent.py``).

DreamerV1's world model, an exploration and a task actor-critic (no target
critics), and the ensembles, which predict the next embedded observation
(the encoder's output) from the latent state and the action.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...models import build_ensembles
from ..dreamer_v1.agent import build_agent as dv1_build_agent
from ..dreamer_v2.agent import DV2Actor, build_actor_critic

Actor = DV2Actor

__all__ = ["Actor", "build_agent"]


def build_agent(cfg: Any, observation_space: Any, actions_dim: Sequence[int], is_continuous: bool,
                device: torch.device) -> Dict[str, nn.Module]:
    """The modules on ``device``, freshly initialised from the torch global
    RNG: ``wm``, ``actor_task``, ``critic_task``, ``actor_exploration``,
    ``critic_exploration`` and ``ensembles`` (output: the encoder's width).
    Load converted weights with ``convert.load_p2e_dv1``."""
    wm_cfg = cfg.algo.world_model
    latent_size = int(wm_cfg.stochastic_size) + int(wm_cfg.recurrent_model.recurrent_state_size)
    wm, actor_exploration, critic_exploration, _ = dv1_build_agent(cfg, observation_space, actions_dim,
                                                                   is_continuous, device)
    actor_task, critic_task = build_actor_critic(cfg, latent_size, actions_dim, is_continuous, layer_norm=False)
    ens = cfg.algo.ensembles
    ensembles = build_ensembles(int(ens.n), int(sum(actions_dim)) + latent_size, wm.encoder.output_dim,
                                int(ens.mlp_layers), int(ens.dense_units), str(ens.dense_act))
    return {"wm": wm, "actor_task": actor_task.to(device), "critic_task": critic_task.to(device),
            "actor_exploration": actor_exploration, "critic_exploration": critic_exploration,
            "ensembles": ensembles.to(device)}
