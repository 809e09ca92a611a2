"""The SAC agent (counterpart of ``sheeprl_tpu/algos/sac/agent.py``).

* ``SACActor``: a two-layer ReLU MLP with ``fc_mean`` and ``fc_logstd``
  heads, log-std clipped to [-5, 2];
* ``sample_actions``: the tanh-squashed Gaussian with the Eq.-26 log-prob
  (``+1e-6`` inside the log) and the action rescaled to the env's bounds; it
  takes pre-drawn standard normal noise or draws it from a generator;
* ``CriticEnsemble``: the ``n`` critics as one module whose weights carry a
  leading ``n`` axis (``models.EnsembleMLP``), run as one batched product
  per layer, as the JAX package's ``nn.vmap`` does; ``[n, B, 1]`` out;
* ``SACAgent``: ``{actor, critic, target_critic, log_alpha}``, the JAX
  package's parameter tree; ``target_critic`` is a copy that takes no
  gradient, ``log_alpha`` starts at ``log(algo.alpha.alpha)``.

Layers take flax's default init (lecun normal kernels, zero biases).
"""
from __future__ import annotations

import copy
import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...envs import spaces
from ...models import MLP, EnsembleMLP, lecun_normal_
from ...models.models import dense

LOG_STD_MAX = 2.0
LOG_STD_MIN = -5.0


class SACActor(nn.Module):
    """``(mean, log_std)`` of the squashed Gaussian policy; ``action_scale``
    and ``action_bias`` map tanh's [-1, 1] onto the env's bounds."""

    def __init__(self, input_dim: int, action_dim: int, hidden_size: int = 256, action_low: Any = -1.0,
                 action_high: Any = 1.0):
        super().__init__()
        self.MLP_0 = MLP(input_dim, (hidden_size, hidden_size), activation="relu", init=lecun_normal_)
        self.fc_mean = dense(hidden_size, action_dim, init=lecun_normal_)
        self.fc_logstd = dense(hidden_size, action_dim, init=lecun_normal_)
        low, high = np.asarray(action_low, np.float32), np.asarray(action_high, np.float32)
        self.register_buffer("action_scale", torch.as_tensor((high - low) / 2.0, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("action_bias", torch.as_tensor((high + low) / 2.0, dtype=torch.float32),
                             persistent=False)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.MLP_0(obs)
        return self.fc_mean(x), torch.clamp(self.fc_logstd(x), LOG_STD_MIN, LOG_STD_MAX)


def sample_actions(actor: SACActor, mean: torch.Tensor, log_std: torch.Tensor, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, greedy: bool = False):
    """``(action, log_prob [..., 1])``: ``x = mean + std·noise`` (``mean``
    when ``greedy``), ``action = tanh(x)·scale + bias`` and the Gaussian
    log-density of ``x`` less ``log(scale·(1 - tanh²(x)) + 1e-6)``, summed
    over the action dims. ``noise`` is a standard normal of ``mean``'s
    shape; without it one is drawn from ``generator``."""
    std = torch.exp(log_std)
    if greedy:
        x = mean
    else:
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        x = mean + std * noise
    y = torch.tanh(x)
    action = y * actor.action_scale + actor.action_bias
    var = torch.square(std)
    log_prob = -0.5 * (torch.square(x - mean) / var + torch.log(2 * math.pi * var))
    log_prob = log_prob - torch.log(actor.action_scale * (1 - torch.square(y)) + 1e-6)
    return action, log_prob.sum(-1, keepdim=True)


class CriticEnsemble(nn.Module):
    """``n`` Q(s, a) networks: concat(obs, action) → ``EnsembleMLP`` (two
    ReLU layers of ``hidden_size`` and a one-unit head) → ``[n, B, 1]``.
    DroQ's critic adds dropout and LayerNorm (``dropout``, ``norm_eps``);
    its keep masks are ``[n, B, hidden]`` per layer (``mask_shapes``)."""

    def __init__(self, input_dim: int, hidden_size: int = 256, n: int = 2, dropout: float = 0.0,
                 norm_eps: Optional[float] = None):
        super().__init__()
        self.n = int(n)
        self.MLP_0 = EnsembleMLP(n, input_dim, (hidden_size, hidden_size), output_dim=1, activation="relu",
                                 norm_eps=norm_eps, dropout=dropout)

    def mask_shapes(self, batch: int):
        return self.MLP_0.mask_shapes(batch)

    def forward(self, obs: torch.Tensor, action: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        return self.MLP_0(torch.cat([obs, action], dim=-1), masks)


class SACAgent(nn.Module):
    """The JAX package's SAC parameter tree as one module."""

    def __init__(self, actor: SACActor, critic: CriticEnsemble, alpha: float):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.target_critic = copy.deepcopy(critic).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.tensor(math.log(alpha), dtype=torch.float32))


def build_actor(cfg: Any, input_dim: int, action_space: Any, hidden_size: int) -> SACActor:
    if not isinstance(action_space, spaces.Box):
        raise ValueError(f"{cfg.algo.name} supports continuous (Box) actions only, got {action_space}")
    return SACActor(input_dim, int(np.prod(action_space.shape)), hidden_size, action_space.low, action_space.high)


def build_agent(cfg: Any, obs_space: Any, action_space: Any, device: Any = "cpu", critic_kwargs=None) -> SACAgent:
    """The agent for ``algo.mlp_keys.encoder`` on ``device`` (DroQ passes its
    critic's dropout and LayerNorm as ``critic_kwargs``)."""
    obs_dim = int(sum(np.prod(obs_space[k].shape) for k in cfg.algo.mlp_keys.encoder))
    actor = build_actor(cfg, obs_dim, action_space, int(cfg.algo.actor.hidden_size))
    act_dim = int(np.prod(action_space.shape))
    critic = CriticEnsemble(obs_dim + act_dim, int(cfg.algo.critic.hidden_size), int(cfg.algo.critic.n),
                            **(critic_kwargs or {}))
    return SACAgent(actor, critic, float(cfg.algo.alpha.alpha)).to(device)
