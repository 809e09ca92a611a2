"""DreamerV3 agent in PyTorch (counterpart of
``sheeprl_tpu/algos/dreamer_v3/agent.py``).

* Module and attribute names follow the JAX package's parameter tree, so
  ``convert.py`` maps a flax tree onto these state dicts by a path rewrite.
* Images stay NHWC at every public function. The encoder and decoder permute
  to NCHW only around each cuDNN convolution (a view: the NHWC buffer is the
  channels-last layout of the NCHW tensor) and back to NHWC before the
  encoder flatten and after the decoder's ``fc`` reshape, so every Dense
  weight maps with a plain transpose.
* The decoder is the JAX package's ``conv_impl=xla`` form: flax
  ``nn.ConvTranspose(k=4, s=2, padding=2, transpose_kernel=True)`` is
  ``nn.ConvTranspose2d(k=4, s=2, p=1)``.
* Every sampler takes its noise explicitly (see distributions.py): pre-drawn
  gumbel/normal tensors, or a ``torch.Generator``.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config.instantiate import locate
from ...distributions import Independent, Normal, OneHotCategoricalStraightThrough
from ...models import MLP, LayerNorm, LayerNormGRUCell, uniform_init_, xavier_normal_
from ...models.models import dense
from ...ops import symlog


def _uniform_mix(logits: torch.Tensor, unimix: float, discrete: int) -> torch.Tensor:
    """1% uniform mixing of categorical probs."""
    if unimix <= 0.0:
        return logits
    logits = logits.reshape(*logits.shape[:-1], -1, discrete)
    probs = torch.softmax(logits, dim=-1)
    probs = (1 - unimix) * probs + unimix * (torch.ones_like(probs) / discrete)
    logits = torch.log(probs)
    return logits.reshape(*logits.shape[:-2], -1)


def compute_stochastic_state(
    logits: torch.Tensor,
    discrete: int,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    sample: bool = True,
) -> torch.Tensor:
    """One-hot straight-through sample of the [*, S, D] categorical state;
    ``noise`` is gumbel of shape [*, S, D]. Returns [*, S, D]."""
    logits = logits.reshape(*logits.shape[:-1], -1, discrete)
    dist = Independent(OneHotCategoricalStraightThrough(logits=logits), 1)
    if sample:
        return dist.rsample(noise, generator)
    return dist.base.mode


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DV3CNNEncoder(nn.Module):
    def __init__(self, keys, in_channels: int, channels_multiplier: int, image_size: int,
                 stages: int = 4, layer_norm: bool = True):
        super().__init__()
        self.keys = tuple(keys)
        self.stages = stages
        self.layer_norm = layer_norm
        prev = in_channels
        for i in range(stages):
            ch = (2**i) * channels_multiplier
            conv = nn.Conv2d(prev, ch, 4, stride=2, padding=1, bias=not layer_norm)
            xavier_normal_(conv.weight)
            if conv.bias is not None:
                nn.init.zeros_(conv.bias)
            setattr(self, f"conv_{i}", conv)
            if layer_norm:
                setattr(self, f"LayerNorm_{i}", LayerNorm(ch, eps=1e-3))
            prev = ch
        self.output_dim = prev * (image_size // 2**stages) ** 2

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        for i in range(self.stages):
            x = _conv_nhwc(getattr(self, f"conv_{i}"), x)
            if self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = F.silu(x)
        return x.reshape(*lead, -1)


class DV3MLPEncoder(nn.Module):
    def __init__(self, keys, input_dim: int, mlp_layers: int = 5, dense_units: int = 1024,
                 layer_norm: bool = True, symlog_inputs: bool = True):
        super().__init__()
        self.keys = tuple(keys)
        self.symlog_inputs = symlog_inputs
        self.MLP_0 = MLP(input_dim, (dense_units,) * mlp_layers, bias=not layer_norm,
                         norm_eps=1e-3 if layer_norm else None)
        self.output_dim = self.MLP_0.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([symlog(obs[k]) if self.symlog_inputs else obs[k] for k in self.keys], dim=-1)
        return self.MLP_0(x)


class DV3Encoder(nn.Module):
    def __init__(self, cnn_keys, mlp_keys, cnn_in_channels: int, mlp_input_dim: int, image_size: int,
                 cnn_channels_multiplier: int = 96, mlp_layers: int = 5, dense_units: int = 1024,
                 layer_norm: bool = True):
        super().__init__()
        self.output_dim = 0
        self.has_cnn, self.has_mlp = bool(cnn_keys), bool(mlp_keys)
        if cnn_keys:
            self.DV3CNNEncoder_0 = DV3CNNEncoder(cnn_keys, cnn_in_channels, cnn_channels_multiplier, image_size)
            self.output_dim += self.DV3CNNEncoder_0.output_dim
        if mlp_keys:
            self.DV3MLPEncoder_0 = DV3MLPEncoder(mlp_keys, mlp_input_dim, mlp_layers, dense_units, layer_norm)
            self.output_dim += self.DV3MLPEncoder_0.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.has_cnn:
            feats.append(self.DV3CNNEncoder_0(obs))
        if self.has_mlp:
            feats.append(self.DV3MLPEncoder_0(obs))
        return torch.cat(feats, dim=-1)


class DV3CNNDecoder(nn.Module):
    def __init__(self, keys, output_channels: Sequence[int], channels_multiplier: int, latent_size: int,
                 image_size: Tuple[int, int] = (64, 64), stages: int = 4, layer_norm: bool = True):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(output_channels)
        self.stages = stages
        self.layer_norm = layer_norm
        self.start = image_size[0] // (2**stages)
        self.c0 = (2 ** (stages - 1)) * channels_multiplier
        self.fc = dense(latent_size, self.start * self.start * self.c0, bias=True)
        prev = self.c0
        for i in range(stages - 1):
            ch = (2 ** (stages - i - 2)) * channels_multiplier
            deconv = nn.ConvTranspose2d(prev, ch, 4, stride=2, padding=1, bias=not layer_norm)
            xavier_normal_(deconv.weight, transposed=True)
            if deconv.bias is not None:
                nn.init.zeros_(deconv.bias)
            setattr(self, f"deconv_{i}", deconv)
            if layer_norm:
                setattr(self, f"LayerNorm_{i}", LayerNorm(ch, eps=1e-3))
            prev = ch
        self.to_obs = nn.ConvTranspose2d(prev, sum(output_channels), 4, stride=2, padding=1, bias=True)
        uniform_init_(self.to_obs.weight, 1.0, transposed=True)
        nn.init.zeros_(self.to_obs.bias)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        lead = latent.shape[:-1]
        x = self.fc(latent).reshape(-1, self.start, self.start, self.c0)
        for i in range(self.stages - 1):
            x = _conv_nhwc(getattr(self, f"deconv_{i}"), x)
            if self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = F.silu(x)
        x = _conv_nhwc(self.to_obs, x)
        x = x.reshape(*lead, *x.shape[1:])
        out: Dict[str, torch.Tensor] = {}
        start = 0
        for k, ch in zip(self.keys, self.output_channels):
            out[k] = x[..., start : start + ch]
            start += ch
        return out


class DV3MLPDecoder(nn.Module):
    def __init__(self, keys, output_dims: Sequence[int], latent_size: int, mlp_layers: int = 5,
                 dense_units: int = 1024, layer_norm: bool = True):
        super().__init__()
        self.keys = tuple(keys)
        self.MLP_0 = MLP(latent_size, (dense_units,) * mlp_layers, bias=not layer_norm,
                         norm_eps=1e-3 if layer_norm else None)
        for k, d in zip(self.keys, output_dims):
            head = dense(self.MLP_0.output_dim, d, bias=True, init=lambda w: uniform_init_(w, 1.0))
            setattr(self, f"head_{k}", head)

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.MLP_0(latent)
        return {k: getattr(self, f"head_{k}")(x) for k in self.keys}


class DV3Decoder(nn.Module):
    def __init__(self, cnn_keys, mlp_keys, cnn_output_channels, mlp_output_dims, latent_size: int,
                 cnn_channels_multiplier: int = 96, image_size: Tuple[int, int] = (64, 64),
                 mlp_layers: int = 5, dense_units: int = 1024, layer_norm: bool = True):
        super().__init__()
        self.has_cnn, self.has_mlp = bool(cnn_keys), bool(mlp_keys)
        if cnn_keys:
            self.DV3CNNDecoder_0 = DV3CNNDecoder(
                cnn_keys, cnn_output_channels, cnn_channels_multiplier, latent_size, image_size
            )
        if mlp_keys:
            self.DV3MLPDecoder_0 = DV3MLPDecoder(
                mlp_keys, mlp_output_dims, latent_size, mlp_layers, dense_units, layer_norm
            )

    def forward(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.has_cnn:
            out.update(self.DV3CNNDecoder_0(latent))
        if self.has_mlp:
            out.update(self.DV3MLPDecoder_0(latent))
        return out


class RecurrentModel(nn.Module):
    """Dense(no-bias) + LN + SiLU → fused LayerNormGRUCell. ``features`` (the
    pre-GRU half) is separate: with the decoupled RSSM the GRU inputs of the
    whole sequence are computed at once and only the recurrence runs in order
    (the LN-GRU sequence kernels, ops/ln_gru.py)."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int):
        super().__init__()
        self.mlp = dense(input_size, dense_units, bias=False)
        self.LayerNorm_0 = LayerNorm(dense_units, eps=1e-3)
        self.gru = LayerNormGRUCell(dense_units, recurrent_state_size, use_bias=False)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.LayerNorm_0(self.mlp(x)))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.gru(h, self.features(x))


class _StochHead(nn.Module):
    """One hidden layer + logits head (transition / representation)."""

    def __init__(self, input_size: int, hidden_size: int, stoch_logits: int, layer_norm: bool = True):
        super().__init__()
        self.layer_norm = layer_norm
        self.Dense_0 = dense(input_size, hidden_size, bias=not layer_norm)
        if layer_norm:
            self.LayerNorm_0 = LayerNorm(hidden_size, eps=1e-3)
        self.logits = dense(hidden_size, stoch_logits, bias=True, init=lambda w: uniform_init_(w, 1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        if self.layer_norm:
            x = self.LayerNorm_0(x)
        return self.logits(F.silu(x))


class RSSM(nn.Module):
    """Recurrent State-Space Model; every method is one step (or, for the
    decoupled helpers, time-parallel over leading axes)."""

    def __init__(self, embed_size: int, action_size: int, stochastic_size: int = 32, discrete_size: int = 32,
                 recurrent_state_size: int = 4096, dense_units: int = 1024, hidden_size: int = 1024,
                 representation_hidden_size: Optional[int] = None, unimix: float = 0.01,
                 learnable_initial_recurrent_state: bool = True, decoupled: bool = False):
        super().__init__()
        self.stochastic_size = stochastic_size
        self.discrete_size = discrete_size
        self.recurrent_state_size = recurrent_state_size
        self.unimix = unimix
        self.decoupled = decoupled
        stoch_flat = stochastic_size * discrete_size
        self.recurrent_model = RecurrentModel(stoch_flat + action_size, recurrent_state_size, dense_units)
        rep_in = embed_size if decoupled else recurrent_state_size + embed_size
        self.representation = _StochHead(rep_in, representation_hidden_size or hidden_size, stoch_flat)
        self.transition = _StochHead(recurrent_state_size, hidden_size, stoch_flat)
        irs = torch.zeros(recurrent_state_size)
        if learnable_initial_recurrent_state:
            self.initial_recurrent_state = nn.Parameter(irs)
        else:
            self.register_buffer("initial_recurrent_state", irs)

    def _transition(self, recurrent_out: torch.Tensor) -> torch.Tensor:
        return _uniform_mix(self.transition(recurrent_out), self.unimix, self.discrete_size)

    def _representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor) -> torch.Tensor:
        if self.decoupled:
            logits = self.representation(embedded_obs)
        else:
            logits = self.representation(torch.cat([recurrent_state, embedded_obs], dim=-1))
        return _uniform_mix(logits, self.unimix, self.discrete_size)

    def initial_states(self, batch_shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        h0 = torch.tanh(self.initial_recurrent_state)
        h0 = h0.expand(*batch_shape, h0.shape[-1])
        z0 = compute_stochastic_state(self._transition(h0), self.discrete_size, sample=False)
        return h0, z0.reshape(*z0.shape[:-2], -1)

    def _reset(self, posterior, recurrent_state, action, is_first, initial):
        action = (1 - is_first) * action
        h0, z0 = initial if initial is not None else self.initial_states(recurrent_state.shape[:-1])
        recurrent_state = (1 - is_first) * recurrent_state + is_first * h0
        posterior = (1 - is_first) * posterior + is_first * z0
        return posterior, recurrent_state, action

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, is_first,
                noise=None, generator=None, initial=None):
        """Coupled step → (h, posterior [B, S*D], post_logits, prior_logits).
        ``initial`` is ``initial_states(B)``, passed in to compute it once."""
        posterior, recurrent_state, action = self._reset(posterior, recurrent_state, action, is_first, initial)
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        prior_logits = self._transition(recurrent_state)
        posterior_logits = self._representation(recurrent_state, embedded_obs)
        new_posterior = compute_stochastic_state(posterior_logits, self.discrete_size, noise, generator)
        new_posterior = new_posterior.reshape(*new_posterior.shape[:-2], -1)
        return recurrent_state, new_posterior, posterior_logits, prior_logits

    def imagination(self, prior, recurrent_state, action, noise=None, generator=None):
        recurrent_state = self.recurrent_model(torch.cat([prior, action], dim=-1), recurrent_state)
        logits = self._transition(recurrent_state)
        imagined = compute_stochastic_state(logits, self.discrete_size, noise, generator)
        return imagined.reshape(*imagined.shape[:-2], -1), recurrent_state

    def recurrent_features(self, z_and_a: torch.Tensor) -> torch.Tensor:
        return self.recurrent_model.features(z_and_a)

    def representation_logits(self, embedded_obs: torch.Tensor) -> torch.Tensor:
        return _uniform_mix(self.representation(embedded_obs), self.unimix, self.discrete_size)

    def dynamic_decoupled(self, posterior, recurrent_state, action, is_first, initial=None):
        """Decoupled step: only h and the prior logits are sequential."""
        posterior, recurrent_state, action = self._reset(posterior, recurrent_state, action, is_first, initial)
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        return recurrent_state, self._transition(recurrent_state)

    def representation_step(self, recurrent_state, embedded_obs, noise=None, generator=None):
        logits = self._representation(recurrent_state, embedded_obs)
        z = compute_stochastic_state(logits, self.discrete_size, noise, generator)
        return z.reshape(*z.shape[:-2], -1)


class DV3Head(nn.Module):
    """MLP trunk + linear head (reward / continue / critic); ``out_scale``
    drives the Hafner output init."""

    def __init__(self, input_size: int, output_dim: int, mlp_layers: int = 5, dense_units: int = 1024,
                 layer_norm: bool = True, out_scale: float = 0.0):
        super().__init__()
        self.MLP_0 = MLP(input_size, (dense_units,) * mlp_layers, bias=not layer_norm,
                         norm_eps=1e-3 if layer_norm else None)
        self.out = dense(self.MLP_0.output_dim, output_dim, bias=True,
                         init=lambda w: uniform_init_(w, out_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.MLP_0(x))


class WorldModel(nn.Module):
    """Encoder + RSSM + decoder + reward + continue. The continue head is
    registered as ``continue`` (the flax name, a Python keyword): reach it
    through ``continue_model``."""

    def __init__(self, encoder: DV3Encoder, rssm: RSSM, observation_model: DV3Decoder,
                 reward: DV3Head, continue_model: DV3Head):
        super().__init__()
        self.encoder = encoder
        self.rssm = rssm
        self.observation_model = observation_model
        self.reward = reward
        self.add_module("continue", continue_model)

    @property
    def continue_model(self) -> DV3Head:
        return self._modules["continue"]

    def embed(self, obs):
        return self.encoder(obs)

    def decode(self, latent):
        return self.observation_model(latent)

    def cont(self, latent):
        return self.continue_model(latent)


class Actor(nn.Module):
    """MLP trunk; one unimix one-hot-ST head per discrete dim, or a
    scaled-Normal head for continuous actions."""

    def __init__(self, latent_size: int, actions_dim: Sequence[int], is_continuous: bool,
                 mlp_layers: int = 5, dense_units: int = 1024, layer_norm: bool = True,
                 unimix: float = 0.01, init_std: float = 2.0, min_std: float = 0.1,
                 max_std: float = 1.0, action_clip: float = 1.0):
        super().__init__()
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = is_continuous
        self.unimix = unimix
        self.init_std, self.min_std, self.max_std = init_std, min_std, max_std
        self.action_clip = action_clip
        self.MLP_0 = MLP(latent_size, (dense_units,) * mlp_layers, bias=not layer_norm,
                         norm_eps=1e-3 if layer_norm else None)
        head_init = lambda w: uniform_init_(w, 1.0)  # noqa: E731
        if is_continuous:
            self.head = dense(self.MLP_0.output_dim, sum(self.actions_dim) * 2, True, head_init)
        else:
            for i, d in enumerate(self.actions_dim):
                setattr(self, f"head_{i}", dense(self.MLP_0.output_dim, d, True, head_init))

    def forward(self, state: torch.Tensor) -> List[torch.Tensor]:
        x = self.MLP_0(state)
        if self.is_continuous:
            return [self.head(x)]
        return [getattr(self, f"head_{i}")(x) for i in range(len(self.actions_dim))]


def actor_dists(actor: Actor, pre_dist: List[torch.Tensor]):
    """The per-head distributions from the actor's raw outputs."""
    if actor.is_continuous:
        mean, std = torch.chunk(pre_dist[0], 2, dim=-1)
        std = (actor.max_std - actor.min_std) * torch.sigmoid(std + actor.init_std) + actor.min_std
        return [Independent(Normal(torch.tanh(mean), std), 1)]
    return [
        OneHotCategoricalStraightThrough(logits=_uniform_mix(logits, actor.unimix, logits.shape[-1]))
        for logits in pre_dist
    ]


# A finite stand-in for the reference's ``-inf`` logit masking: exp(MASK_LOGIT -
# lse) underflows to exactly 0.0, so a masked action has zero probability
# while entropy and log-prob stay free of NaN (the JAX package's value).
MASK_LOGIT = -1e9


class MinedojoActor(Actor):
    """The DreamerV3 actor with MineDojo's action masks. The parameters and
    the forward pass are ``Actor``'s; the masks apply at sampling time in
    ``sample_actor_actions``: head 0 (action type) by ``mask_action_type``,
    head 1 (craft/smelt argument) by ``mask_craft_smelt`` where the sampled
    type is 15 (craft), head 2 (item argument) by ``mask_equip_place`` where
    it is 16 or 17 (equip, place) and by ``mask_destroy`` where it is 18
    (destroy)."""

    masked_heads = True


def apply_minedojo_masks(pre_dist: List[torch.Tensor], mask: Dict[str, Any],
                         functional_action: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Each head's (unimixed) logits with its mask applied. With no
    ``functional_action`` (head 0 not sampled yet) only head 0 is masked;
    the caller masks heads 1 and 2 once head 0's index is known."""
    out = list(pre_dist)

    def m(name: str, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mask[name]), dtype=torch.bool, device=like.device).expand_as(like)

    if "mask_action_type" in mask:
        out[0] = torch.where(m("mask_action_type", out[0]), out[0], torch.full_like(out[0], MASK_LOGIT))
    if functional_action is None:
        return out
    fa = functional_action[..., None]
    if len(out) > 1 and "mask_craft_smelt" in mask:
        out[1] = torch.where((fa == 15) & ~m("mask_craft_smelt", out[1]), torch.full_like(out[1], MASK_LOGIT), out[1])
    if len(out) > 2:
        if "mask_equip_place" in mask:
            off = ((fa == 16) | (fa == 17)) & ~m("mask_equip_place", out[2])
            out[2] = torch.where(off, torch.full_like(out[2], MASK_LOGIT), out[2])
        if "mask_destroy" in mask:
            out[2] = torch.where((fa == 18) & ~m("mask_destroy", out[2]), torch.full_like(out[2], MASK_LOGIT), out[2])
    return out


def sample_actor_actions(
    actor: Actor,
    pre_dist: List[torch.Tensor],
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    greedy: bool = False,
    mask: Optional[Dict[str, Any]] = None,
):
    """Sample (or take the mode of) each action head. ``noise`` holds one
    tensor per head: gumbel [*, A_i] for a discrete head, standard normal
    [*, A] for the continuous one. With a ``mask`` dict and a masking actor
    (``MinedojoActor``) the heads are sampled in order, head 0's index
    gating the masks of heads 1 and 2. Returns (actions, dists)."""
    noise = list(noise) if noise is not None else [None] * len(pre_dist)
    if mask and getattr(actor, "masked_heads", False) and not actor.is_continuous:
        mixed = apply_minedojo_masks([_uniform_mix(l, actor.unimix, l.shape[-1]) for l in pre_dist], mask)
        d0 = OneHotCategoricalStraightThrough(logits=mixed[0])
        a0 = d0.mode if greedy else d0.rsample(noise[0], generator)
        mixed = apply_minedojo_masks(mixed, mask, torch.argmax(a0, dim=-1))
        dists = [OneHotCategoricalStraightThrough(logits=l) for l in mixed]
        actions = [a0] + [d.mode if greedy else d.rsample(n, generator) for d, n in zip(dists[1:], noise[1:])]
        return actions, dists
    dists = actor_dists(actor, pre_dist)
    actions: List[torch.Tensor] = []
    if actor.is_continuous:
        act = dists[0].mode if greedy else dists[0].rsample(noise[0], generator)
        if actor.action_clip > 0:
            clip = torch.full_like(act, actor.action_clip)
            act = act * (clip / torch.maximum(clip, torch.abs(act))).detach()
        actions.append(act)
    else:
        for d, n in zip(dists, noise):
            actions.append(d.mode if greedy else d.rsample(n, generator))
    return actions, dists


def build_actor_critic(cfg: Any, latent_size: int, actions_dim: Sequence[int], is_continuous: bool):
    """An actor (``algo.actor.cls``: ``Actor`` or ``MinedojoActor``) and a critic head,
    freshly initialised from the torch global RNG."""
    actor_path = str(cfg.algo.actor.select("cls") or f"{__name__}.Actor")
    actor_cls = locate(actor_path)
    if actor_cls not in (Actor, MinedojoActor):
        raise NotImplementedError(f"algo.actor.cls={actor_path}: the DreamerV3 Actor and MinedojoActor are ported")
    actor = actor_cls(
        latent_size,
        actions_dim=tuple(actions_dim),
        is_continuous=is_continuous,
        mlp_layers=int(cfg.algo.actor.mlp_layers),
        dense_units=int(cfg.algo.actor.dense_units),
        unimix=float(cfg.algo.actor.unimix),
        init_std=float(cfg.algo.actor.init_std),
        min_std=float(cfg.algo.actor.min_std),
        max_std=float(cfg.algo.actor.max_std),
        action_clip=float(cfg.algo.actor.action_clip),
    )
    critic = DV3Head(latent_size, int(cfg.algo.critic.bins), int(cfg.algo.critic.mlp_layers),
                     int(cfg.algo.critic.dense_units), out_scale=0.0)
    return actor, critic


def build_agent(
    cfg: Any,
    observation_space: Any,
    actions_dim: Sequence[int],
    is_continuous: bool,
    device: torch.device,
):
    """Construct (world_model, actor, critic, target_critic) on ``device``,
    freshly initialised from the torch global RNG (seed it first); load
    converted weights with ``convert.py``."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    conv_impl = str(wm_cfg.select("conv_impl", "auto"))
    if conv_impl not in ("auto", "xla"):
        raise NotImplementedError(
            f"algo.world_model.conv_impl={conv_impl}: the port runs native (cuDNN) convolutions, "
            "the JAX package's xla form; set auto or xla"
        )
    screen = int(cfg.env.screen_size)
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    latent_size = stoch_flat + R
    mlp_dims = [int(np.prod(observation_space[k].shape)) for k in mlp_keys]
    encoder = DV3Encoder(
        cnn_keys, mlp_keys,
        cnn_in_channels=sum(observation_space[k].shape[-1] for k in cnn_keys),
        mlp_input_dim=sum(mlp_dims),
        image_size=screen,
        cnn_channels_multiplier=int(wm_cfg.encoder.cnn_channels_multiplier),
        mlp_layers=int(wm_cfg.encoder.mlp_layers),
        dense_units=int(wm_cfg.encoder.dense_units),
    )
    rssm = RSSM(
        embed_size=encoder.output_dim,
        action_size=int(sum(actions_dim)),
        stochastic_size=int(wm_cfg.stochastic_size),
        discrete_size=int(wm_cfg.discrete_size),
        recurrent_state_size=R,
        dense_units=int(wm_cfg.recurrent_model.dense_units),
        hidden_size=int(wm_cfg.transition_model.hidden_size),
        representation_hidden_size=int(wm_cfg.representation_model.hidden_size),
        unimix=float(cfg.algo.unimix),
        learnable_initial_recurrent_state=bool(wm_cfg.learnable_initial_recurrent_state),
        decoupled=bool(wm_cfg.select("decoupled_rssm") or False),
    )
    decoder = DV3Decoder(
        cnn_keys, mlp_keys,
        cnn_output_channels=[observation_space[k].shape[-1] for k in cnn_keys],
        mlp_output_dims=mlp_dims,
        latent_size=latent_size,
        cnn_channels_multiplier=int(wm_cfg.observation_model.cnn_channels_multiplier),
        image_size=(screen, screen),
        mlp_layers=int(wm_cfg.observation_model.mlp_layers),
        dense_units=int(wm_cfg.observation_model.dense_units),
    )
    reward = DV3Head(latent_size, int(wm_cfg.reward_model.bins), int(wm_cfg.reward_model.mlp_layers),
                     int(wm_cfg.reward_model.dense_units), out_scale=0.0)
    cont = DV3Head(latent_size, 1, int(wm_cfg.discount_model.mlp_layers),
                   int(wm_cfg.discount_model.dense_units), out_scale=1.0)
    world_model = WorldModel(encoder, rssm, decoder, reward, cont)
    actor, critic = build_actor_critic(cfg, latent_size, actions_dim, is_continuous)
    target_critic = copy.deepcopy(critic)
    target_critic.requires_grad_(False)
    return world_model.to(device), actor.to(device), critic.to(device), target_critic.to(device)
