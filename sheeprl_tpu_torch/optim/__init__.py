"""Optimizers (counterpart of ``sheeprl_tpu/optim/__init__.py``, the DreamerV3
subset: ``adam`` and ``clipped``).

``adam`` is ``torch.optim.Adam`` — the same update as optax adam, with eps
outside the square root: ``lr · m̂ / (sqrt(v̂) + eps)`` — or ``AdamW`` when
``weight_decay`` is set (optax ``adamw``'s decoupled decay). ``clipped`` puts
global-norm clipping in front of an optimizer exactly as
``optax.clip_by_global_norm`` does: the gradients are scaled by
``max_norm / ‖g‖`` only when ``‖g‖ >= max_norm`` (no epsilon, unlike
``torch.nn.utils.clip_grad_norm_``).
"""
from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence

import torch


def adam(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-3,
    eps: float = 1e-8,
    betas: Sequence[float] = (0.9, 0.999),
    weight_decay: float = 0.0,
    **_: Any,
) -> torch.optim.Optimizer:
    betas = (float(betas[0]), float(betas[1]))
    if weight_decay:
        return torch.optim.AdamW(params, lr=float(lr), betas=betas, eps=float(eps), weight_decay=float(weight_decay))
    return torch.optim.Adam(params, lr=float(lr), betas=betas, eps=float(eps))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place: ``g ← g / ‖g‖ · max_norm`` for every g when ``‖g‖ >= max_norm``.
    Returns the global norm. No host synchronisation."""
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Clipped:
    """An optimizer with global-norm gradient clipping in front of its step."""

    def __init__(self, optimizer: torch.optim.Optimizer, max_grad_norm: Optional[float]):
        self.optimizer = optimizer
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm and max_grad_norm > 0 else None

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.max_grad_norm is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            if grads:
                clip_by_global_norm_(grads, self.max_grad_norm)
        self.optimizer.step()


def clipped(optimizer: torch.optim.Optimizer, max_grad_norm: Optional[float]) -> Clipped:
    """Compose global-norm clipping in front of an optimizer."""
    return Clipped(optimizer, max_grad_norm)
