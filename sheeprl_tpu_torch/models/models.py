"""Core NN building blocks (PyTorch), the subset of
``sheeprl_tpu/models/models.py`` that DreamerV3, the on-policy and the
off-policy families use (``MLP`` with dropout, ``NatureCNN``,
``LayerNormGRUCell``), the dict-observation ``MultiEncoder`` and
``MultiDecoder``, and the ensemble layers that stand for the JAX
package's ``nn.vmap``-lifted critics (``EnsembleLinear``,
``EnsembleLayerNorm``, ``EnsembleMLP``).

``GRUCell`` is flax's ``nn.GRUCell`` (DreamerV1's recurrent cell).

Module and attribute names follow the JAX package's parameter tree (``dense_0``,
``LayerNorm_0``, ``fused`` ...), so ``convert.py`` maps a flax tree onto a
state dict by a path rewrite. The JAX package's ``LayerNorm`` wraps a flax
``nn.LayerNorm``; here one module holds ``weight`` (flax ``scale``) and
``bias``.

Inits follow the JAX package: ``xavier_normal_`` is JAX's ``glorot_normal``
(a truncated normal), ``uniform_init_`` its scaled fan-avg uniform.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu is the tanh form
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation named as in the JAX package's configs (``tanh``,
    ``relu``, ... or a class path such as ``torch.nn.SiLU``)."""
    if name is None:
        return _ACTIVATIONS["identity"]
    key = str(name).rsplit(".", 1)[-1].lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'")
    return _ACTIVATIONS[key]


def _fans(t: torch.Tensor, transposed: bool = False):
    """(fan_in, fan_out) of a Linear [out, in], Conv2d [out, in, kh, kw] or,
    with ``transposed``, ConvTranspose2d [in, out, kh, kw] weight."""
    receptive = t[0][0].numel() if t.dim() > 2 else 1
    n_in, n_out = (t.shape[0], t.shape[1]) if transposed else (t.shape[1], t.shape[0])
    return n_in * receptive, n_out * receptive


@torch.no_grad()
def variance_scaling_(t: torch.Tensor, scale: float, mode: str, distribution: str, transposed: bool = False):
    """``jax.nn.initializers.variance_scaling`` for a torch weight layout."""
    fan_in, fan_out = _fans(t, transposed)
    denom = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
    variance = scale / max(1.0, denom)
    if distribution == "truncated_normal":
        # JAX's constant: std of a unit normal truncated to [-2, 2]
        std = math.sqrt(variance) / 0.87962566103423978
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std)
    elif distribution == "uniform":
        limit = math.sqrt(3 * variance)
        nn.init.uniform_(t, -limit, limit)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    return t


def xavier_normal_(t: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    return variance_scaling_(t, 1.0, "fan_avg", "truncated_normal", transposed)


def uniform_init_(t: torch.Tensor, scale: float, transposed: bool = False) -> torch.Tensor:
    """Hafner output-head init: scaled xavier-uniform; scale 0.0 → zeros."""
    if scale == 0.0:
        with torch.no_grad():
            return t.zero_()
    return variance_scaling_(t, scale, "fan_avg", "uniform", transposed)


def lecun_normal_(t: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense``'s default kernel init."""
    return variance_scaling_(t, 1.0, "fan_in", "truncated_normal")


def dense(in_features: int, out_features: int, bias: bool = True, init=xavier_normal_) -> nn.Linear:
    layer = nn.Linear(in_features, out_features, bias=bias)
    init(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class LayerNorm(nn.Module):
    """Dtype-preserving LayerNorm over the last axis, computed in float32."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(normalized_shape))
        self.bias = nn.Parameter(torch.zeros(normalized_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            # one launch: the kernel normalises in f32 (its accumulation
            # type) and rounds once, also for bf16 inputs and parameters
            return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)
        out = F.layer_norm(x.float(), self.weight.shape, self.weight.float(), self.bias.float(), self.eps)
        return out.to(x.dtype)


def dropout(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout`` with a given keep ``mask``: kept entries scaled by
    ``1 / (1 - rate)``, the others zero."""
    return torch.where(mask, x / (1.0 - rate), 0.0)


def draw_masks(shapes: Sequence[Tuple[int, ...]], rate: float, generator: Optional[torch.Generator],
               device: Any) -> List[torch.Tensor]:
    """One keep mask (``True`` with probability ``1 - rate``) per shape, from
    ``generator``."""
    return [torch.rand(s, generator=generator, device=device) < 1.0 - rate for s in shapes]


class MLP(nn.Module):
    """Linear → Dropout → Norm → activation stack with an optional linear
    ``out`` head (the JAX package's ``MLP``). The defaults are DreamerV3's
    (SiLU, Hafner init); the other agents pass ``activation`` and flax's
    ``lecun_normal_``. Dropout (``dropout`` > 0) runs where ``forward`` is
    given keep ``masks``, one per hidden layer (``draw_masks``); without
    them the stack is deterministic, as flax's with ``deterministic=True``."""

    def __init__(
        self,
        input_dim: int,
        hidden_sizes: Sequence[int] = (),
        bias: bool = True,
        norm_eps: Optional[float] = None,
        init=xavier_normal_,
        activation: str = "silu",
        output_dim: Optional[int] = None,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.n_layers = len(hidden_sizes)
        self.hidden_sizes = tuple(int(h) for h in hidden_sizes)
        self.layer_norm = norm_eps is not None
        self.act = get_activation(activation)
        self.dropout = float(dropout)
        prev = input_dim
        for i, h in enumerate(hidden_sizes):
            setattr(self, f"dense_{i}", dense(prev, h, bias, init))
            if self.layer_norm:
                setattr(self, f"LayerNorm_{i}", LayerNorm(h, eps=norm_eps))
            prev = h
        self.has_out = output_dim is not None
        if self.has_out:
            self.out = dense(prev, int(output_dim), bias, init)
            prev = int(output_dim)
        self.output_dim = prev

    def forward(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if masks is not None and self.dropout > 0:
                x = dropout(x, masks[i], self.dropout)
            if self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = self.act(x)
        return self.out(x) if self.has_out else x


class EnsembleLinear(nn.Module):
    """``n`` independent linear layers run as one batched product: ``weight``
    ``[n, in, out]`` (the layout of a flax ``Dense`` kernel under ``nn.vmap``)
    and ``bias`` ``[n, out]``. Takes ``[B, in]`` (shared by the members) or
    ``[n, B, in]``; returns ``[n, B, out]``. Each member's kernel has flax's
    lecun-normal init."""

    def __init__(self, n: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))
        std = math.sqrt(1.0 / max(1, in_features)) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand(self.weight.shape[0], *x.shape)
        return torch.baddbmm(self.bias.unsqueeze(1), x, self.weight)


class EnsembleLayerNorm(nn.Module):
    """``n`` LayerNorms over the last axis of ``[n, B, h]``, each with its own
    ``weight`` and ``bias`` (``[n, h]``)."""

    def __init__(self, n: int, h: int, eps: float = 1e-5):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(n, h))
        self.bias = nn.Parameter(torch.zeros(n, h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        return torch.addcmul(self.bias.unsqueeze(1), y, self.weight.unsqueeze(1))


class EnsembleMLP(nn.Module):
    """``MLP`` for ``n`` members at once (the JAX package's ``MLP`` under
    ``nn.vmap`` with ``variable_axes={"params": 0}``): the same submodule
    names, every weight with a leading ``n`` axis. Dropout masks are
    ``[n, B, h]``, so each member draws its own."""

    def __init__(self, n: int, input_dim: int, hidden_sizes: Sequence[int], output_dim: Optional[int] = None,
                 activation: str = "relu", norm_eps: Optional[float] = None, dropout: float = 0.0):
        super().__init__()
        self.n = int(n)
        self.n_layers = len(hidden_sizes)
        self.hidden_sizes = tuple(int(h) for h in hidden_sizes)
        self.layer_norm = norm_eps is not None
        self.act = get_activation(activation)
        self.dropout = float(dropout)
        prev = input_dim
        for i, h in enumerate(hidden_sizes):
            setattr(self, f"dense_{i}", EnsembleLinear(n, prev, h))
            if self.layer_norm:
                setattr(self, f"LayerNorm_{i}", EnsembleLayerNorm(n, h, eps=norm_eps))
            prev = h
        self.has_out = output_dim is not None
        if self.has_out:
            self.out = EnsembleLinear(n, prev, int(output_dim))

    def mask_shapes(self, batch: int) -> List[Tuple[int, int, int]]:
        return [(self.n, batch, h) for h in self.hidden_sizes]

    def forward(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if masks is not None and self.dropout > 0:
                x = dropout(x, masks[i], self.dropout)
            if self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = self.act(x)
        return self.out(x) if self.has_out else x


def _valid_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


class NatureCNN(nn.Module):
    """The DQN-Nature encoder (the JAX package's ``NatureCNN``): three VALID
    convolutions (32x8/4, 64x4/2, 64x3/1) with ReLU and a ReLU dense layer to
    ``features_dim``. Takes uint8 or float images ``[..., H, W, C]`` scaled
    by 1/255. The convolutions run on NCHW; the flatten before ``Dense_0``
    keeps the JAX package's NHWC order, so a converted dense kernel lines up
    with it."""

    def __init__(self, in_channels: int, image_hw: Tuple[int, int], features_dim: int = 512):
        super().__init__()
        self.features_dim = int(features_dim)
        self.Conv_0 = nn.Conv2d(in_channels, 32, 8, 4)
        self.Conv_1 = nn.Conv2d(32, 64, 4, 2)
        self.Conv_2 = nn.Conv2d(64, 64, 3, 1)
        h, w = image_hw
        for k, s in ((8, 4), (4, 2), (3, 1)):
            h, w = _valid_out(h, k, s), _valid_out(w, k, s)
        if h < 1 or w < 1:
            raise ValueError(f"NatureCNN needs images of at least 36x36, got {tuple(image_hw)}")
        self.Dense_0 = dense(64 * h * w, self.features_dim, init=lecun_normal_)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            lecun_normal_(conv.weight)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2).float() / 255.0
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = F.relu(self.Dense_0(x))
        return x.reshape(*lead, self.features_dim)


class LayerNormGRUCell(nn.Module):
    """Hafner-style LN-GRU cell: one fused matmul of concat([x, h]) against a
    [3H, F+H] weight → LN (eps 1e-3; none with ``layer_norm=False``) →
    split(reset, cand, update), with the ``update = σ(u - 1)`` bias trick.
    ``forward(h, x)`` returns the new h."""

    def __init__(self, input_size: int, hidden_size: int, use_bias: bool = False, layer_norm: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.layer_norm = layer_norm
        self.fused = dense(input_size + hidden_size, 3 * hidden_size, bias=use_bias, init=lecun_normal_)
        if layer_norm:
            self.LayerNorm_0 = LayerNorm(3 * hidden_size, eps=1e-3)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        y = self.fused(torch.cat([x, h], dim=-1))
        if self.layer_norm:
            y = self.LayerNorm_0(y)
        reset, cand, update = torch.split(y, self.hidden_size, dim=-1)
        reset = torch.sigmoid(reset)
        cand = torch.tanh(reset * cand)
        update = torch.sigmoid(update - 1.0)
        return update * cand + (1.0 - update) * h


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell``, with its parameters: the input projections
    ``ir``, ``iz``, ``in`` carry a bias, the hidden ones ``hr`` and ``hz``
    none, and ``hn`` its own bias inside the reset product:

        r = σ(W_ir x + b_ir + W_hr h),  z = σ(W_iz x + b_iz + W_hz h),
        n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn)),  h' = (1 - z) ⊙ n + z ⊙ h.

    The three input and the three hidden kernels are stacked (``weight_i``
    [3H, in], ``bias_i`` [3H], ``weight_h`` [3H, H] in the order r, z, n,
    and ``bias_hn`` [H]), so a step is two matmuls; ``convert.py`` stacks a
    flax tree's six kernels the same way. torch's ``nn.GRUCell`` would train
    separate hidden r/z biases, which receive the same gradient as the input
    ones and make Adam move the gate bias twice per step. Inits follow flax:
    lecun-normal input kernels, orthogonal hidden kernels, zero biases.
    ``forward(h, x)``, flax's ``(carry, inputs)`` order, returns the new h."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_i = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.bias_i = nn.Parameter(torch.zeros(3 * hidden_size))
        self.weight_h = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_hn = nn.Parameter(torch.zeros(hidden_size))
        for i in range(3):
            lecun_normal_(self.weight_i.data[i * hidden_size:(i + 1) * hidden_size])
            nn.init.orthogonal_(self.weight_h.data[i * hidden_size:(i + 1) * hidden_size])

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        H = self.hidden_size
        gi = F.linear(x, self.weight_i, self.bias_i)
        gh = F.linear(h, self.weight_h)
        r = torch.sigmoid(gi[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gi[..., 2 * H:] + r * (gh[..., 2 * H:] + self.bias_hn))
        return (1.0 - z) * n + z * h


class MultiEncoder(nn.Module):
    """Dict-observation fusion encoder: ``cnn_encoder`` takes the image keys,
    ``mlp_encoder`` the vector keys (either may be None), and their features
    are concatenated on the last axis. The attribute names are the flax
    module's, so ``convert.load_multi`` maps its tree by path."""

    def __init__(self, cnn_encoder: Optional[nn.Module], mlp_encoder: Optional[nn.Module]):
        super().__init__()
        if cnn_encoder is None and mlp_encoder is None:
            raise ValueError("MultiEncoder needs a cnn_encoder or an mlp_encoder")
        self.cnn_encoder, self.mlp_encoder = cnn_encoder, mlp_encoder

    def forward(self, obs) -> torch.Tensor:
        return torch.cat([e(obs) for e in (self.cnn_encoder, self.mlp_encoder) if e is not None], dim=-1)


class MultiDecoder(nn.Module):
    """Dict-observation decoder: the union of the ``cnn_decoder``'s and the
    ``mlp_decoder``'s reconstruction dicts (either may be None)."""

    def __init__(self, cnn_decoder: Optional[nn.Module], mlp_decoder: Optional[nn.Module]):
        super().__init__()
        if cnn_decoder is None and mlp_decoder is None:
            raise ValueError("MultiDecoder needs a cnn_decoder or an mlp_decoder")
        self.cnn_decoder, self.mlp_decoder = cnn_decoder, mlp_decoder

    def forward(self, features: torch.Tensor):
        out = {}
        for d in (self.cnn_decoder, self.mlp_decoder):
            if d is not None:
                out.update(d(features))
        return out
