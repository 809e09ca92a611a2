"""DreamerV2 agent in PyTorch (counterpart of
``sheeprl_tpu/algos/dreamer_v2/agent.py``).

* ``DV2CNNEncoder``: four 4x4 stride-2 VALID convolutions of 2^i·m
  channels (64 → 31 → 14 → 6 → 2), an optional channel-last LayerNorm and
  the activation (ELU by default), flattened in NHWC order so a converted
  Dense kernel lines up; ``DV2MLPEncoder``: an MLP over the vector keys.
* ``DV2CNNDecoder``: ``fc`` to the encoder's flat width, viewed as a 1x1
  image, then transposed convolutions with kernels 5, 5, 6, 6 at stride 2,
  VALID (1 → 5 → 13 → 30 → 64), split per key, NHWC. The JAX package's
  ``ConvTranspose`` has ``transpose_kernel=False`` (a convolution of the
  dilated input with the kernel as laid out): torch's ``ConvTranspose2d``
  with the kernel flipped in space, so the layers carry
  ``flax_transpose_kernel = False`` and ``convert.py`` flips them.
* ``DV2RSSM``: zero initial states, a 32x32 one-hot straight-through
  stochastic state without unimix, the recurrent model a Dense with
  LayerNorm and activation and then the LN-GRU cell with a bias.
* ``DV2Actor`` and ``dv2_actor_dists``: one categorical head per discrete
  action, or a (mean, std) head with a ``trunc_normal`` (the default for a
  continuous action), ``tanh_normal`` or ``normal`` distribution;
  ``dv2_sample_actions`` and ``dv2_exploration_noise`` take pre-drawn noise
  or a generator.

The convolutions run on cuDNN in NCHW; the JAX package's ``conv_impl``
(``einsum``, its lowering for XLA on the CPU, or ``xla``) names two
computations of the same function with one parameter tree, and the port
runs that function for any of the three values. Module and attribute names
follow the JAX package's parameter tree (see ``convert.py``); inits follow
flax (lecun-normal kernels, zero biases).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config.instantiate import locate
from ...distributions import (
    Independent,
    Normal,
    OneHotCategoricalStraightThrough,
    TanhNormal,
    TruncatedNormal,
    gumbel_noise,
    truncnorm_uniform,
)
from ...models import MLP, LayerNorm, LayerNormGRUCell, get_activation, lecun_normal_, variance_scaling_
from ...models.models import dense
from .utils import compute_stochastic_state

LN_EPS = 1e-5  # the JAX package's LayerNorm default
CONV_IMPLS = ("auto", "einsum", "xla")


def cnn_encoder_output_dim(channels_multiplier: int) -> int:
    """Flat width of the CNN encoder's output at 64x64: 2x2 pixels of 8·m
    channels."""
    return 8 * channels_multiplier * 2 * 2


def _mlp(input_dim: int, units: int, layers: int, layer_norm: bool, act: str, bias: Optional[bool] = None) -> MLP:
    return MLP(input_dim, (units,) * layers, bias=(not layer_norm) if bias is None else bias,
               norm_eps=LN_EPS if layer_norm else None, init=lecun_normal_, activation=act)


def _conv(cin: int, cout: int, bias: bool) -> nn.Conv2d:
    layer = nn.Conv2d(cin, cout, 4, stride=2, bias=bias)
    lecun_normal_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _deconv(cin: int, cout: int, kernel: int, bias: bool) -> nn.ConvTranspose2d:
    layer = nn.ConvTranspose2d(cin, cout, kernel, stride=2, bias=bias)
    variance_scaling_(layer.weight, 1.0, "fan_in", "truncated_normal", transposed=True)
    if bias:
        nn.init.zeros_(layer.bias)
    layer.flax_transpose_kernel = False
    return layer


def _channel_ln(ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channels of an NCHW tensor."""
    return ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class DV2CNNEncoder(nn.Module):
    def __init__(self, keys: Sequence[str], in_channels: int, channels_multiplier: int, image_size: int = 64,
                 layer_norm: bool = False, activation: str = "elu", stages: int = 4):
        super().__init__()
        self.keys = tuple(keys)
        self.stages = stages
        self.layer_norm = layer_norm
        self.act = get_activation(activation)
        prev, size = in_channels, image_size
        for i in range(stages):
            ch = (2**i) * channels_multiplier
            setattr(self, f"conv_{i}", _conv(prev, ch, bias=not layer_norm))
            if layer_norm:
                setattr(self, f"LayerNorm_{i}", LayerNorm(ch, eps=LN_EPS))
            prev, size = ch, (size - 4) // 2 + 1
        self.output_dim = prev * size * size

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(self.stages):
            x = getattr(self, f"conv_{i}")(x)
            if self.layer_norm:
                x = _channel_ln(getattr(self, f"LayerNorm_{i}"), x)
            x = self.act(x)
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)  # NHWC order


class DV2MLPEncoder(nn.Module):
    def __init__(self, keys: Sequence[str], input_dim: int, mlp_layers: int = 4, dense_units: int = 400,
                 layer_norm: bool = False, activation: str = "elu"):
        super().__init__()
        self.keys = tuple(keys)
        self.MLP_0 = _mlp(input_dim, dense_units, mlp_layers, layer_norm, activation)
        self.output_dim = self.MLP_0.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.MLP_0(torch.cat([obs[k] for k in self.keys], dim=-1))


class DV2Encoder(nn.Module):
    def __init__(self, cnn_keys, mlp_keys, cnn_in_channels: int, mlp_input_dim: int, image_size: int = 64,
                 cnn_channels_multiplier: int = 48, mlp_layers: int = 4, dense_units: int = 400,
                 layer_norm: bool = False, cnn_act: str = "elu", dense_act: str = "elu"):
        super().__init__()
        self.has_cnn, self.has_mlp = bool(cnn_keys), bool(mlp_keys)
        self.output_dim = 0
        if self.has_cnn:
            self.DV2CNNEncoder_0 = DV2CNNEncoder(cnn_keys, cnn_in_channels, cnn_channels_multiplier, image_size,
                                                 layer_norm, cnn_act)
            self.output_dim += self.DV2CNNEncoder_0.output_dim
        if self.has_mlp:
            self.DV2MLPEncoder_0 = DV2MLPEncoder(mlp_keys, mlp_input_dim, mlp_layers, dense_units, layer_norm,
                                                 dense_act)
            self.output_dim += self.DV2MLPEncoder_0.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.has_cnn:
            feats.append(self.DV2CNNEncoder_0(obs))
        if self.has_mlp:
            feats.append(self.DV2MLPEncoder_0(obs))
        return torch.cat(feats, dim=-1)


class DV2CNNDecoder(nn.Module):
    """``fc`` → 1x1 image → deconvs k5, k5, k6, k6 at stride 2, VALID → the
    image keys' channels at 64x64, NHWC."""

    KERNELS = (5, 5, 6, 6)

    def __init__(self, keys: Sequence[str], output_channels: Sequence[int], channels_multiplier: int,
                 cnn_encoder_output_dim: int, latent_size: int, layer_norm: bool = False, activation: str = "elu"):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(int(c) for c in output_channels)
        self.layer_norm = layer_norm
        self.act = get_activation(activation)
        self.fc = dense(latent_size, cnn_encoder_output_dim, bias=True, init=lecun_normal_)
        self.fc_dim = cnn_encoder_output_dim
        m = channels_multiplier
        prev = cnn_encoder_output_dim
        for i, ch in enumerate((4 * m, 2 * m, m)):
            setattr(self, f"deconv_{i}", _deconv(prev, ch, self.KERNELS[i], bias=not layer_norm))
            if layer_norm:
                setattr(self, f"LayerNorm_{i}", LayerNorm(ch, eps=LN_EPS))
            prev = ch
        self.to_obs = _deconv(prev, sum(self.output_channels), self.KERNELS[3], bias=True)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        lead = latent.shape[:-1]
        x = self.fc(latent).reshape(-1, self.fc_dim, 1, 1)
        for i in range(3):
            x = getattr(self, f"deconv_{i}")(x)
            if self.layer_norm:
                x = _channel_ln(getattr(self, f"LayerNorm_{i}"), x)
            x = self.act(x)
        x = self.to_obs(x).permute(0, 2, 3, 1)
        x = x.reshape(*lead, *x.shape[1:])
        out: Dict[str, torch.Tensor] = {}
        start = 0
        for k, ch in zip(self.keys, self.output_channels):
            out[k] = x[..., start : start + ch]
            start += ch
        return out


class DV2MLPDecoder(nn.Module):
    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], latent_size: int, mlp_layers: int = 4,
                 dense_units: int = 400, layer_norm: bool = False, activation: str = "elu"):
        super().__init__()
        self.keys = tuple(keys)
        self.MLP_0 = _mlp(latent_size, dense_units, mlp_layers, layer_norm, activation)
        for k, d in zip(self.keys, output_dims):
            setattr(self, f"head_{k}", dense(self.MLP_0.output_dim, int(d), bias=True, init=lecun_normal_))

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.MLP_0(latent)
        return {k: getattr(self, f"head_{k}")(x) for k in self.keys}


class DV2Decoder(nn.Module):
    def __init__(self, cnn_keys, mlp_keys, cnn_output_channels, mlp_output_dims, latent_size: int,
                 cnn_channels_multiplier: int = 48, cnn_encoder_output_dim: int = 0, mlp_layers: int = 4,
                 dense_units: int = 400, layer_norm: bool = False, cnn_act: str = "elu", dense_act: str = "elu"):
        super().__init__()
        self.has_cnn, self.has_mlp = bool(cnn_keys), bool(mlp_keys)
        if self.has_cnn:
            self.DV2CNNDecoder_0 = DV2CNNDecoder(cnn_keys, cnn_output_channels, cnn_channels_multiplier,
                                                 cnn_encoder_output_dim, latent_size, layer_norm, cnn_act)
        if self.has_mlp:
            self.DV2MLPDecoder_0 = DV2MLPDecoder(mlp_keys, mlp_output_dims, latent_size, mlp_layers, dense_units,
                                                 layer_norm, dense_act)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.has_cnn:
            out.update(self.DV2CNNDecoder_0(latent))
        if self.has_mlp:
            out.update(self.DV2MLPDecoder_0(latent))
        return out


class DV2RecurrentModel(nn.Module):
    """Dense [+ LN] + activation → the LN-GRU cell with a bias (its
    LayerNorm on with ``layer_norm``)."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int = 400, layer_norm: bool = True,
                 activation: str = "elu"):
        super().__init__()
        self.MLP_0 = _mlp(input_size, dense_units, 1, layer_norm, activation)
        self.gru = LayerNormGRUCell(dense_units, recurrent_state_size, use_bias=True, layer_norm=layer_norm)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.gru(h, self.MLP_0(x))


class _DV2StochHead(nn.Module):
    """One hidden layer and the logits (transition / representation)."""

    def __init__(self, input_size: int, hidden_size: int, stoch_logits: int, layer_norm: bool = False,
                 activation: str = "elu"):
        super().__init__()
        self.MLP_0 = _mlp(input_size, hidden_size, 1, layer_norm, activation)
        self.logits = dense(hidden_size, stoch_logits, bias=True, init=lecun_normal_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits(self.MLP_0(x))


class DV2RSSM(nn.Module):
    """Zero initial states, a discrete S x D one-hot straight-through state,
    no unimix. Every method is one step; ``noise`` is gumbel [B, S, D]."""

    def __init__(self, embed_size: int, action_size: int, stochastic_size: int = 32, discrete_size: int = 32,
                 recurrent_state_size: int = 600, dense_units: int = 400, hidden_size: int = 600,
                 representation_hidden_size: Optional[int] = None, layer_norm: bool = False,
                 recurrent_layer_norm: bool = True, dense_act: str = "elu"):
        super().__init__()
        self.stochastic_size = stochastic_size
        self.discrete_size = discrete_size
        self.recurrent_state_size = recurrent_state_size
        self.stoch_width = stochastic_size * discrete_size
        self.recurrent_model = DV2RecurrentModel(self.stoch_width + action_size, recurrent_state_size, dense_units,
                                                 recurrent_layer_norm, dense_act)
        self.representation = _DV2StochHead(recurrent_state_size + embed_size,
                                            representation_hidden_size or hidden_size, self.stoch_width,
                                            layer_norm, dense_act)
        self.transition = _DV2StochHead(recurrent_state_size, hidden_size, self.stoch_width, layer_norm, dense_act)

    def _sample(self, logits: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        z = compute_stochastic_state(logits, self.discrete_size, noise, generator)
        return z.reshape(*z.shape[:-2], -1)

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, is_first, noise=None, generator=None):
        """Reset on ``is_first`` (to zeros), one recurrent step, the prior and
        posterior logits and a posterior sample → (h, posterior [B, S*D],
        posterior_logits, prior_logits)."""
        action = (1 - is_first) * action
        posterior = (1 - is_first) * posterior
        recurrent_state = (1 - is_first) * recurrent_state
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        prior_logits = self.transition(recurrent_state)
        posterior_logits = self.representation(torch.cat([recurrent_state, embedded_obs], dim=-1))
        return recurrent_state, self._sample(posterior_logits, noise, generator), posterior_logits, prior_logits

    def imagination(self, prior, recurrent_state, action, noise=None, generator=None):
        recurrent_state = self.recurrent_model(torch.cat([prior, action], dim=-1), recurrent_state)
        return self._sample(self.transition(recurrent_state), noise, generator), recurrent_state

    def representation_step(self, recurrent_state, embedded_obs, noise=None, generator=None):
        logits = self.representation(torch.cat([recurrent_state, embedded_obs], dim=-1))
        return self._sample(logits, noise, generator)


class DV2Head(nn.Module):
    """MLP trunk + linear head (reward / continue / critic)."""

    def __init__(self, input_size: int, output_dim: int, mlp_layers: int = 4, dense_units: int = 400,
                 layer_norm: bool = False, activation: str = "elu"):
        super().__init__()
        self.MLP_0 = _mlp(input_size, dense_units, mlp_layers, layer_norm, activation)
        self.out = dense(self.MLP_0.output_dim, output_dim, bias=True, init=lecun_normal_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.MLP_0(x))


class DV2WorldModel(nn.Module):
    """Encoder + RSSM + decoder + reward [+ continue]. The continue head is
    registered as ``continue`` (the flax name, a Python keyword): reach it
    through ``cont``. Shared by DreamerV1 with its Gaussian RSSM."""

    def __init__(self, encoder: nn.Module, rssm: nn.Module, observation_model: nn.Module, reward: nn.Module,
                 continue_model: Optional[nn.Module] = None):
        super().__init__()
        self.encoder = encoder
        self.rssm = rssm
        self.observation_model = observation_model
        self.reward = reward
        self.use_continues = continue_model is not None
        if continue_model is not None:
            self.add_module("continue", continue_model)

    def embed(self, obs):
        return self.encoder(obs)

    def decode(self, latent):
        return self.observation_model(latent)

    def cont(self, latent):
        if not self.use_continues:
            raise RuntimeError("continue model disabled (algo.world_model.use_continues=False)")
        return self._modules["continue"](latent)


class DV2Actor(nn.Module):
    """MLP trunk (with biases, also under LayerNorm); one head per discrete
    action, or one (mean, std) head for a continuous action."""

    def __init__(self, latent_size: int, actions_dim: Sequence[int], is_continuous: bool, distribution: str = "auto",
                 init_std: float = 0.0, min_std: float = 0.1, mlp_layers: int = 4, dense_units: int = 400,
                 layer_norm: bool = False, activation: str = "elu"):
        super().__init__()
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = is_continuous
        self.distribution = str(distribution).lower()
        self.init_std, self.min_std = float(init_std), float(min_std)
        self.MLP_0 = _mlp(latent_size, dense_units, mlp_layers, layer_norm, activation, bias=True)
        if is_continuous:
            self.head = dense(self.MLP_0.output_dim, sum(self.actions_dim) * 2, True, lecun_normal_)
        else:
            for i, d in enumerate(self.actions_dim):
                setattr(self, f"head_{i}", dense(self.MLP_0.output_dim, d, True, lecun_normal_))

    def resolved_distribution(self) -> str:
        if self.distribution == "auto":
            return "trunc_normal" if self.is_continuous else "discrete"
        return self.distribution

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.MLP_0(state)
        if self.is_continuous:
            return [self.head(x)]
        return [getattr(self, f"head_{i}")(x) for i in range(len(self.actions_dim))]


def dv2_actor_dists(actor: DV2Actor, pre_dist: List[torch.Tensor]):
    """The per-head distributions from the actor's raw outputs."""
    if actor.is_continuous:
        dist_type = actor.resolved_distribution()
        mean, std = torch.chunk(pre_dist[0], 2, dim=-1)
        if dist_type == "tanh_normal":
            mean = 5.0 * torch.tanh(mean / 5.0)
            std = F.softplus(std + actor.init_std) + actor.min_std
            return [Independent(TanhNormal(mean, std), 1)]
        if dist_type == "normal":
            return [Independent(Normal(mean, std), 1)]
        std = 2.0 * torch.sigmoid((std + actor.init_std) / 2.0) + actor.min_std
        return [Independent(TruncatedNormal(torch.tanh(mean), std, -1.0, 1.0), 1)]
    return [OneHotCategoricalStraightThrough(logits=lg) for lg in pre_dist]


def action_noise(actor: DV2Actor, lead: Sequence[int], generator, device) -> List[torch.Tensor]:
    """One action draw's noise, per head: gumbel [*lead, A_i] for a discrete
    head, the uniform of a ``trunc_normal`` or the standard normal of a
    ``tanh_normal``/``normal`` head [*lead, A]."""
    lead = tuple(lead)
    if not actor.is_continuous:
        return [gumbel_noise((*lead, a), generator, device) for a in actor.actions_dim]
    shape = (*lead, sum(actor.actions_dim))
    if actor.resolved_distribution() in ("tanh_normal", "normal"):
        return [torch.randn(shape, generator=generator, device=device)]
    return [truncnorm_uniform(shape, generator, device)]


def dv2_sample_actions(actor: DV2Actor, pre_dist: List[torch.Tensor], noise: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None, greedy: bool = False):
    """Sample (or, ``greedy``, take the mode of) each head; ``noise`` as
    ``action_noise`` gives it. The greedy continuous action is the mode, as
    in the JAX package. Returns (actions, dists)."""
    dists = dv2_actor_dists(actor, pre_dist)
    noise = list(noise) if noise is not None else [None] * len(dists)
    actions = [d.mode if greedy else d.rsample(n, generator) for d, n in zip(dists, noise)]
    return actions, dists


def exploration_noise_draws(actor: DV2Actor, batch: int, generator, device) -> List[Tuple[torch.Tensor, ...]]:
    """The exploration draws of one player step, per head: a standard normal
    [B, A] for the continuous head; a gumbel [B, A_i] (the random action)
    and a uniform [B, 1] (whether it replaces the actor's) per discrete
    head."""
    if actor.is_continuous:
        return [(torch.randn(batch, sum(actor.actions_dim), generator=generator, device=device),)]
    return [(gumbel_noise((batch, a), generator, device), torch.rand(batch, 1, generator=generator, device=device))
            for a in actor.actions_dim]


def apply_exploration(actor: DV2Actor, actions: List[torch.Tensor], expl_amount: float,
                      draws: Sequence[Tuple[torch.Tensor, ...]]) -> List[torch.Tensor]:
    """Continuous: ``clip(a + expl·ε, -1, 1)``; discrete: each row replaced
    by a uniformly random one-hot action with probability ``expl``."""
    out = []
    for act, draw in zip(actions, draws):
        if actor.is_continuous:
            out.append(torch.clamp(act + draw[0] * expl_amount, -1.0, 1.0))
        else:
            gumbel, u = draw
            rand = F.one_hot(torch.argmax(gumbel, dim=-1), act.shape[-1]).to(act.dtype)
            out.append(torch.where(u < expl_amount, rand, act))
    return out


def dv2_exploration_noise(actor: DV2Actor, actions: List[torch.Tensor], expl_amount: float,
                          draws: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
                          generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    """Exploration noise on sampled actions (``apply_exploration``); an
    amount of 0 or less leaves them as they are."""
    if expl_amount <= 0.0:
        return actions
    if draws is None:
        draws = exploration_noise_draws(actor, actions[0].shape[0], generator, actions[0].device)
    return apply_exploration(actor, actions, expl_amount, draws)


def _act(cfg: Any, section: str) -> str:
    return str(cfg.select(f"algo.{section}.dense_act") or cfg.algo.dense_act)


def build_actor_critic(cfg: Any, latent_size: int, actions_dim: Sequence[int], is_continuous: bool,
                       layer_norm: Optional[bool] = None, actor_cls: type = DV2Actor):
    """The actor (checked against ``algo.actor.cls``) and the critic head of
    DreamerV1 and V2 (``layer_norm`` None: each section's own)."""
    actor_path = str(cfg.algo.actor.select("cls") or f"{actor_cls.__module__}.{actor_cls.__name__}")
    if locate(actor_path) is not actor_cls:
        raise NotImplementedError(f"algo.actor.cls={actor_path}: only {actor_cls.__name__} is ported")
    actor = actor_cls(
        latent_size,
        actions_dim=tuple(actions_dim),
        is_continuous=is_continuous,
        distribution=str(cfg.select("distribution.type") or "auto"),
        init_std=float(cfg.algo.actor.init_std),
        min_std=float(cfg.algo.actor.min_std),
        mlp_layers=int(cfg.algo.actor.mlp_layers),
        dense_units=int(cfg.algo.actor.dense_units),
        layer_norm=bool(cfg.algo.actor.layer_norm) if layer_norm is None else layer_norm,
        activation=_act(cfg, "actor"),
    )
    critic = DV2Head(latent_size, 1, int(cfg.algo.critic.mlp_layers), int(cfg.algo.critic.dense_units),
                     bool(cfg.algo.critic.layer_norm) if layer_norm is None else layer_norm, _act(cfg, "critic"))
    return actor, critic


def build_encoder_decoder(cfg: Any, observation_space: Any, latent_size: int, layer_norm: bool):
    """The encoder and decoder DreamerV1 and V2 share."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    conv_impl = str(wm_cfg.select("conv_impl", "auto"))
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of auto|einsum|xla, got {conv_impl!r}")
    screen = int(cfg.env.screen_size)
    if cnn_keys and screen != 64:
        raise ValueError(f"the DreamerV1/V2 convolutions take 64x64 images, got env.screen_size={screen}")
    mlp_dims = [int(np.prod(observation_space[k].shape)) for k in mlp_keys]
    m = int(wm_cfg.encoder.cnn_channels_multiplier)
    encoder = DV2Encoder(
        cnn_keys, mlp_keys,
        cnn_in_channels=sum(int(observation_space[k].shape[-1]) for k in cnn_keys),
        mlp_input_dim=sum(mlp_dims),
        image_size=screen,
        cnn_channels_multiplier=m,
        mlp_layers=int(wm_cfg.encoder.mlp_layers),
        dense_units=int(wm_cfg.encoder.dense_units),
        layer_norm=layer_norm,
        cnn_act=str(cfg.algo.cnn_act),
        dense_act=str(cfg.algo.dense_act),
    )
    decoder = DV2Decoder(
        cnn_keys, mlp_keys,
        cnn_output_channels=[int(observation_space[k].shape[-1]) for k in cnn_keys],
        mlp_output_dims=mlp_dims,
        latent_size=latent_size,
        cnn_channels_multiplier=int(wm_cfg.observation_model.cnn_channels_multiplier),
        cnn_encoder_output_dim=cnn_encoder_output_dim(m),
        mlp_layers=int(wm_cfg.observation_model.mlp_layers),
        dense_units=int(wm_cfg.observation_model.dense_units),
        layer_norm=layer_norm,
        cnn_act=str(cfg.algo.cnn_act),
        dense_act=str(cfg.algo.dense_act),
    )
    return encoder, decoder


def build_agent(cfg: Any, observation_space: Any, actions_dim: Sequence[int], is_continuous: bool,
                device: torch.device):
    """(world_model, actor, critic, target_critic) on ``device``, freshly
    initialised from the torch global RNG (seed it first); load converted
    weights with ``convert.load_dreamer_v2``."""
    wm_cfg = cfg.algo.world_model
    layer_norm = bool(cfg.algo.layer_norm)
    dense_act = str(cfg.algo.dense_act)
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    latent_size = S * D + R
    encoder, decoder = build_encoder_decoder(cfg, observation_space, latent_size, layer_norm)
    rssm = DV2RSSM(
        embed_size=encoder.output_dim,
        action_size=int(sum(actions_dim)),
        stochastic_size=S,
        discrete_size=D,
        recurrent_state_size=R,
        dense_units=int(wm_cfg.recurrent_model.dense_units),
        hidden_size=int(wm_cfg.transition_model.hidden_size),
        representation_hidden_size=int(wm_cfg.representation_model.hidden_size),
        layer_norm=layer_norm,
        recurrent_layer_norm=bool(wm_cfg.recurrent_model.layer_norm),
        dense_act=dense_act,
    )
    reward = DV2Head(latent_size, 1, int(wm_cfg.reward_model.mlp_layers), int(wm_cfg.reward_model.dense_units),
                     layer_norm, dense_act)
    cont = None
    if bool(wm_cfg.use_continues):
        cont = DV2Head(latent_size, 1, int(wm_cfg.discount_model.mlp_layers),
                       int(wm_cfg.discount_model.dense_units), layer_norm, dense_act)
    world_model = DV2WorldModel(encoder, rssm, decoder, reward, cont)
    actor, critic = build_actor_critic(cfg, latent_size, actions_dim, is_continuous)
    target_critic = copy.deepcopy(critic)
    target_critic.requires_grad_(False)
    return world_model.to(device), actor.to(device), critic.to(device), target_critic.to(device)
