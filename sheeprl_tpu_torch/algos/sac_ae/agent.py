"""The SAC-AE agent (counterpart of ``sheeprl_tpu/algos/sac_ae/agent.py``),
pixel SAC with an autoencoder (https://arxiv.org/abs/1910.01741).

* ``SACAEEncoder``: for the image keys four 3x3 VALID convolutions of
  32·m channels with strides 2, 1, 1, 1 and ReLU, flattened in NHWC order
  (the JAX package's layout, so a converted ``fc`` kernel lines up), then
  ``fc``, LayerNorm and tanh (``detach_conv`` cuts the gradient at the
  convolutions' output); for the vector keys an MLP; the two concatenated;
* ``SACAEDecoder``: ``fc``, reshaped NHWC to the encoder's convolution
  output, three stride-1 transposed convolutions with ReLU and one
  stride-2 to the image keys' channels (63x63 at 64x64 frames), zero-padded
  to the screen size after the bias, split per key, NHWC; an MLP with one
  head per vector key;
* the Q ensemble (``sac.agent.CriticEnsemble`` on the features) and SAC's
  actor on the features;
* ``SACAEAgent``: ``{encoder, qs, actor, decoder, log_alpha,
  target_encoder, target_qs}``, the JAX package's tree.

The convolutions run in NCHW on cuDNN (the JAX package's
``ops/conv_einsum.py`` is a lowering for XLA on the CPU, not a kernel).
flax's ``nn.ConvTranspose`` here has ``transpose_kernel=False``: a
convolution of the dilated input with the kernel as laid out
(``[kh, kw, in, out]``), which is torch's ``ConvTranspose2d`` with the
kernel flipped in space; the transposed layers carry
``flax_transpose_kernel = False`` so that ``convert.py`` flips them.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import MLP, LayerNorm, lecun_normal_, variance_scaling_
from ...models.models import dense
from ..sac.agent import CriticEnsemble, SACActor, build_actor

LN_EPS = 1e-5  # the JAX package's LayerNorm default


def conv_output_shape(screen_size: int, channels_multiplier: int) -> Tuple[int, int, int]:
    """(H, W, C) of the encoder's convolutions at ``screen_size``."""
    s = (screen_size - 3) // 2 + 1 - 6
    return (s, s, 32 * channels_multiplier)


def _conv(cin: int, cout: int, stride: int) -> nn.Conv2d:
    layer = nn.Conv2d(cin, cout, 3, stride)
    lecun_normal_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


def _deconv(cin: int, cout: int, stride: int) -> nn.ConvTranspose2d:
    layer = nn.ConvTranspose2d(cin, cout, 3, stride)
    variance_scaling_(layer.weight, 1.0, "fan_in", "truncated_normal", transposed=True)
    nn.init.zeros_(layer.bias)
    layer.flax_transpose_kernel = False
    return layer


class SACAECNNEncoder(nn.Module):
    def __init__(self, keys: Sequence[str], in_channels: int, screen_size: int, features_dim: int,
                 channels_multiplier: int = 1):
        super().__init__()
        self.keys = tuple(keys)
        m = 32 * channels_multiplier
        for i, stride in enumerate((2, 1, 1, 1)):
            setattr(self, f"conv_{i}", _conv(in_channels if i == 0 else m, m, stride))
        h, w, c = conv_output_shape(screen_size, channels_multiplier)
        self.fc = dense(h * w * c, features_dim, init=lecun_normal_)
        self.LayerNorm_0 = LayerNorm(features_dim, eps=LN_EPS)

    def forward(self, obs: Dict[str, torch.Tensor], detach_conv: bool = False) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)  # NHWC order
        if detach_conv:
            x = x.detach()
        return torch.tanh(self.LayerNorm_0(self.fc(x)))


class SACAEMLPEncoder(nn.Module):
    def __init__(self, keys: Sequence[str], input_dim: int, dense_units: int = 64, mlp_layers: int = 2,
                 layer_norm: bool = False):
        super().__init__()
        self.keys = tuple(keys)
        self.MLP_0 = MLP(input_dim, (dense_units,) * mlp_layers, activation="relu", init=lecun_normal_,
                         norm_eps=LN_EPS if layer_norm else None)
        self.output_dim = self.MLP_0.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.MLP_0(torch.cat([obs[k] for k in self.keys], dim=-1))


class SACAEEncoder(nn.Module):
    def __init__(self, obs_space: Any, cnn_keys: Sequence[str], mlp_keys: Sequence[str], screen_size: int,
                 features_dim: int, channels_multiplier: int = 1, dense_units: int = 64, mlp_layers: int = 2,
                 layer_norm: bool = False):
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.output_dim = 0
        if self.cnn_keys:
            channels = sum(int(obs_space[k].shape[-1]) for k in self.cnn_keys)
            self.SACAECNNEncoder_0 = SACAECNNEncoder(self.cnn_keys, channels, screen_size, features_dim,
                                                     channels_multiplier)
            self.output_dim += features_dim
        if self.mlp_keys:
            dim = int(sum(np.prod(obs_space[k].shape) for k in self.mlp_keys))
            self.SACAEMLPEncoder_0 = SACAEMLPEncoder(self.mlp_keys, dim, dense_units, mlp_layers, layer_norm)
            self.output_dim += self.SACAEMLPEncoder_0.output_dim

    def forward(self, obs: Dict[str, torch.Tensor], detach_conv: bool = False) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            feats.append(self.SACAECNNEncoder_0(obs, detach_conv))
        if self.mlp_keys:
            feats.append(self.SACAEMLPEncoder_0(obs))
        return torch.cat(feats, dim=-1)


class SACAECNNDecoder(nn.Module):
    def __init__(self, keys: Sequence[str], key_channels: Sequence[int], features_dim: int,
                 conv_shape: Tuple[int, int, int], channels_multiplier: int = 1, screen_size: int = 64):
        super().__init__()
        self.keys, self.key_channels = tuple(keys), tuple(int(c) for c in key_channels)
        self.conv_shape, self.screen_size = tuple(conv_shape), int(screen_size)
        m = 32 * channels_multiplier
        h, w, c = conv_shape
        self.fc = dense(features_dim, h * w * c, init=lecun_normal_)
        for i in range(3):
            setattr(self, f"deconv_{i}", _deconv(c if i == 0 else m, m, 1))
        self.to_obs = _deconv(m, sum(self.key_channels), 2)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        h, w, c = self.conv_shape
        lead = features.shape[:-1]
        x = self.fc(features).reshape(-1, h, w, c).permute(0, 3, 1, 2)
        for i in range(3):
            x = F.relu(getattr(self, f"deconv_{i}")(x))
        x = self.to_obs(x)
        # the padding to the screen size comes after the bias, as zeros
        x = F.pad(x, (0, self.screen_size - x.shape[-1], 0, self.screen_size - x.shape[-2]))
        x = x.permute(0, 2, 3, 1).reshape(*lead, *x.shape[-2:], x.shape[1])
        return dict(zip(self.keys, torch.split(x, self.key_channels, dim=-1)))


class SACAEMLPDecoder(nn.Module):
    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], features_dim: int, dense_units: int = 64,
                 mlp_layers: int = 2):
        super().__init__()
        self.keys = tuple(keys)
        self.MLP_0 = MLP(features_dim, (dense_units,) * mlp_layers, activation="relu", init=lecun_normal_)
        for k, d in zip(self.keys, output_dims):
            setattr(self, f"head_{k}", dense(dense_units, int(d), init=lecun_normal_))

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.MLP_0(features)
        return {k: getattr(self, f"head_{k}")(x) for k in self.keys}


class SACAEDecoder(nn.Module):
    def __init__(self, obs_space: Any, cnn_keys: Sequence[str], mlp_keys: Sequence[str], features_dim: int,
                 screen_size: int, channels_multiplier: int = 1, dense_units: int = 64, mlp_layers: int = 2):
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        if self.cnn_keys:
            self.SACAECNNDecoder_0 = SACAECNNDecoder(
                self.cnn_keys, [obs_space[k].shape[-1] for k in self.cnn_keys], features_dim,
                conv_output_shape(screen_size, channels_multiplier), channels_multiplier, screen_size)
        if self.mlp_keys:
            self.SACAEMLPDecoder_0 = SACAEMLPDecoder(
                self.mlp_keys, [int(np.prod(obs_space[k].shape)) for k in self.mlp_keys], features_dim, dense_units,
                mlp_layers)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_keys:
            out.update(self.SACAECNNDecoder_0(features))
        if self.mlp_keys:
            out.update(self.SACAEMLPDecoder_0(features))
        return out


class SACAEAgent(nn.Module):
    """The JAX package's SAC-AE parameter tree as one module."""

    def __init__(self, encoder: SACAEEncoder, qs: CriticEnsemble, actor: SACActor, decoder: SACAEDecoder,
                 alpha: float):
        super().__init__()
        self.encoder, self.qs, self.actor, self.decoder = encoder, qs, actor, decoder
        self.log_alpha = nn.Parameter(torch.tensor(math.log(alpha), dtype=torch.float32))
        self.target_encoder = copy.deepcopy(encoder).requires_grad_(False)
        self.target_qs = copy.deepcopy(qs).requires_grad_(False)


def build_agent(cfg: Any, obs_space: Any, action_space: Any, device: Any = "cpu") -> SACAEAgent:
    algo = cfg.algo
    cnn_keys, mlp_keys = tuple(algo.cnn_keys.encoder), tuple(algo.mlp_keys.encoder)
    screen, mult = int(cfg.env.screen_size), int(algo.cnn_channels_multiplier)
    features = int(algo.encoder.features_dim)
    encoder = SACAEEncoder(obs_space, cnn_keys, mlp_keys, screen, features, mult, int(algo.dense_units),
                           int(algo.mlp_layers), bool(algo.layer_norm))
    decoder = SACAEDecoder(obs_space, cnn_keys, mlp_keys, encoder.output_dim, screen, mult, int(algo.dense_units),
                           int(algo.mlp_layers))
    actor = build_actor(cfg, encoder.output_dim, action_space, int(algo.hidden_size))
    act_dim = int(np.prod(action_space.shape))
    qs = CriticEnsemble(encoder.output_dim + act_dim, int(algo.hidden_size), int(algo.critic.n))
    return SACAEAgent(encoder, qs, actor, decoder, float(algo.alpha.alpha)).to(device)
