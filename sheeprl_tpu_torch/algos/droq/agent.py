"""The DroQ agent (counterpart of ``sheeprl_tpu/algos/droq/agent.py``): SAC's
actor and a critic ensemble of Linear → Dropout → LayerNorm → ReLU, twice,
then the one-unit head (https://arxiv.org/abs/2110.02034). Each member draws
its own dropout masks (``[n, B, hidden]`` per layer), as the JAX package's
``nn.vmap`` with ``split_rngs={"dropout": True}`` means them to.

The JAX package passes ``deterministic=False`` to its vmapped critic, and
flax's ``nn.vmap`` drops keyword arguments (it warns "kwargs are not
supported in vmap"), so its critics run without dropout; the port applies
the configured dropout (a departure the README states).
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from ...models import draw_masks
from ..sac.agent import CriticEnsemble, SACAgent
from ..sac.agent import build_agent as build_sac_agent

LN_EPS = 1e-5  # the JAX package's LayerNorm default


def build_agent(cfg: Any, obs_space: Any, action_space: Any, device: Any = "cpu") -> SACAgent:
    """SAC's agent with DroQ's critic (``algo.critic.dropout``, LayerNorm)."""
    return build_sac_agent(cfg, obs_space, action_space, device,
                           critic_kwargs={"dropout": float(cfg.algo.critic.dropout), "norm_eps": LN_EPS})


def critic_masks(critic: CriticEnsemble, batch: int, generator: Optional[torch.Generator],
                 device: Any) -> List[torch.Tensor]:
    """One call's keep masks for every member and layer, from ``generator``."""
    return draw_masks(critic.mask_shapes(batch), critic.MLP_0.dropout, generator, device)
