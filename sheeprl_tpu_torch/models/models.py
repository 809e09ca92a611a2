"""Core NN building blocks (PyTorch), the DreamerV3 subset of
``sheeprl_tpu/models/models.py``.

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
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

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


class MLP(nn.Module):
    """Linear → Norm → SiLU stack (the JAX package's ``MLP`` with the DV3
    options: SiLU, no dropout, no output head)."""

    def __init__(
        self,
        input_dim: int,
        hidden_sizes: Sequence[int] = (),
        bias: bool = True,
        norm_eps: Optional[float] = None,
        init=xavier_normal_,
    ):
        super().__init__()
        self.n_layers = len(hidden_sizes)
        self.layer_norm = norm_eps is not None
        prev = input_dim
        for i, h in enumerate(hidden_sizes):
            setattr(self, f"dense_{i}", dense(prev, h, bias, init))
            if self.layer_norm:
                setattr(self, f"LayerNorm_{i}", LayerNorm(h, eps=norm_eps))
            prev = h
        self.output_dim = prev

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if self.layer_norm:
                x = getattr(self, f"LayerNorm_{i}")(x)
            x = F.silu(x)
        return x


class LayerNormGRUCell(nn.Module):
    """Hafner-style LN-GRU cell: one fused matmul of concat([x, h]) against a
    [3H, F+H] weight → LN (eps 1e-3) → split(reset, cand, update), with the
    ``update = σ(u - 1)`` bias trick. ``forward(h, x)`` returns the new h."""

    def __init__(self, input_size: int, hidden_size: int, use_bias: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.fused = dense(input_size + hidden_size, 3 * hidden_size, bias=use_bias, init=lecun_normal_)
        self.LayerNorm_0 = LayerNorm(3 * hidden_size, eps=1e-3)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        y = self.LayerNorm_0(self.fused(torch.cat([x, h], dim=-1)))
        reset, cand, update = torch.split(y, self.hidden_size, dim=-1)
        reset = torch.sigmoid(reset)
        cand = torch.tanh(reset * cand)
        update = torch.sigmoid(update - 1.0)
        return update * cand + (1.0 - update) * h
