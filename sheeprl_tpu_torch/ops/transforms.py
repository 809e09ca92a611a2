"""Elementwise numeric transforms: symlog/symexp, two-hot encoding.

Counterpart of ``sheeprl_tpu/ops/transforms.py``; plain tensor code.
"""
from __future__ import annotations

import torch


def unrolled_cumprod(x: torch.Tensor) -> torch.Tensor:
    """Cumulative product over the leading axis as a multiply chain, in the
    same order as the JAX package (``torch.cumprod`` would do too; the chain
    keeps the rounding identical)."""
    outs = [x[0]]
    for t in range(1, x.shape[0]):
        outs.append(outs[-1] * x[t])
    return torch.stack(outs, dim=0)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.expm1(torch.abs(x))


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: int = 255) -> torch.Tensor:
    """Two-hot encode scalars onto ``num_buckets`` bins spanning
    [-support_range, support_range] in symlog space. Input [..., 1] →
    output [..., num_buckets]."""
    x = symlog(x)[..., 0]
    support = torch.linspace(-support_range, support_range, num_buckets, device=x.device, dtype=x.dtype)
    x = torch.clamp(x, -support_range, support_range)
    idx_low = (support <= x[..., None]).sum(-1) - 1
    idx_low = torch.clamp(idx_low, 0, num_buckets - 1)
    idx_high = torch.clamp(idx_low + 1, 0, num_buckets - 1)
    low_val = support[idx_low]
    high_val = support[idx_high]
    denom = high_val - low_val
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    frac = torch.where(denom > 0, (x - low_val) / safe, torch.zeros_like(x))
    oh_low = torch.nn.functional.one_hot(idx_low, num_buckets).to(x.dtype) * (1.0 - frac)[..., None]
    oh_high = torch.nn.functional.one_hot(idx_high, num_buckets).to(x.dtype) * frac[..., None]
    return oh_low + oh_high


def two_hot_decoder(probs: torch.Tensor, support_range: int = 300) -> torch.Tensor:
    """Decode a two-hot distribution back to a scalar."""
    num_buckets = probs.shape[-1]
    support = torch.linspace(-support_range, support_range, num_buckets, device=probs.device, dtype=probs.dtype)
    return symexp((probs * support).sum(-1, keepdim=True))
