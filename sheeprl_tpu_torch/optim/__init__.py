"""Optimizers (counterpart of ``sheeprl_tpu/optim/__init__.py``: ``adam``,
``rmsprop``, ``rmsprop_tf`` and ``clipped``).

``adam`` is ``torch.optim.Adam`` — the same update as optax adam, with eps
outside the square root: ``lr · m̂ / (sqrt(v̂) + eps)`` — or ``AdamW`` when
``weight_decay`` is set (optax ``adamw``'s decoupled decay). ``clipped`` puts
global-norm clipping in front of an optimizer exactly as
``optax.clip_by_global_norm`` does: the gradients are scaled by
``max_norm / ‖g‖`` only when ``‖g‖ >= max_norm`` (no epsilon, unlike
``torch.nn.utils.clip_grad_norm_``).

``rmsprop`` is the JAX package's ``optax.rmsprop``, not
``torch.optim.RMSprop``: optax (``eps_in_sqrt=True``, its default) scales a
gradient by ``1 / sqrt(ν + eps)``, torch by ``1 / (sqrt(ν) + eps)``; with
A2C's eps of 1e-4 the two differ from the first step.

``rmsprop_tf`` is the TF-style RMSprop that DreamerV1 and V2 use (the JAX
package's ``rmsprop_tf``): like ``rmsprop``, eps inside the square root,
but the squared average starts at ones and the learning rate multiplies the
update before it enters the momentum buffer.
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


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay=alpha, eps, momentum, centered)`` with
    optax's defaults (``initial_scale=0``, ``eps_in_sqrt=True``, no bias
    correction, no Nesterov), as one chain:

    * ``ν ← α·ν + (1-α)·g²`` (centered: also ``μ ← α·μ + (1-α)·g``,
      ``ν̃ = ν - μ²``), ``u = g · rsqrt(ν̃ + eps)``;
    * ``u ← -lr · u``, then with momentum ``m ← u + momentum·m``, ``u = m``;
    * ``p ← p + u``.

    State per parameter: ``nu`` (optax's ``ν``), ``mu`` when centered,
    ``momentum_buffer`` with momentum, and ``step``."""

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99, eps: float = 1e-8, momentum: float = 0.0,
                 centered: bool = False):
        super().__init__(params, dict(lr=float(lr), alpha=float(alpha), eps=float(eps), momentum=float(momentum or 0.0),
                                      centered=bool(centered)))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, alpha, eps, momentum = group["lr"], group["alpha"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["nu"] = torch.zeros_like(p)
                    if group["centered"]:
                        st["mu"] = torch.zeros_like(p)
                    if momentum:
                        st["momentum_buffer"] = torch.zeros_like(p)
                st["step"] += 1
                nu = st["nu"]
                nu.mul_(alpha).add_((1.0 - alpha) * g.square())
                var = nu
                if group["centered"]:
                    st["mu"].mul_(alpha).add_((1.0 - alpha) * g)
                    var = nu - st["mu"].square()
                u = g * torch.rsqrt(var + eps) * -lr
                if momentum:
                    buf = st["momentum_buffer"]
                    buf.mul_(momentum).add_(u)
                    u = buf
                p.add_(u)


def rmsprop(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-2,
    alpha: float = 0.99,
    eps: float = 1e-8,
    momentum: float = 0.0,
    centered: bool = False,
    **_: Any,
) -> torch.optim.Optimizer:
    return RMSprop(params, lr=lr, alpha=alpha, eps=eps, momentum=momentum, centered=centered)


class RMSpropTF(torch.optim.Optimizer):
    """The JAX package's ``rmsprop_tf(lr, alpha, eps, momentum, centered)``
    (its ``RMSpropTFState``: ``square_avg``, ``momentum_buf``, ``grad_avg``):

    * ``s ← α·s + (1-α)·g²`` from ``s = 1`` (centered: also
      ``a ← α·a + (1-α)·g`` from 0, and ``d = sqrt(s - a² + eps)``, else
      ``d = sqrt(s + eps)``);
    * ``u = lr · g / d``; with momentum ``m ← momentum·m + u``, ``u = m``;
    * ``p ← p - u``.

    State per parameter: ``square_avg``, ``grad_avg`` when centered,
    ``momentum_buffer`` with momentum, and ``step``."""

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99, eps: float = 1e-8, momentum: float = 0.0,
                 centered: bool = False):
        super().__init__(params, dict(lr=float(lr), alpha=float(alpha), eps=float(eps), momentum=float(momentum or 0.0),
                                      centered=bool(centered)))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, alpha, eps, momentum = group["lr"], group["alpha"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["square_avg"] = torch.ones_like(p)
                    if group["centered"]:
                        st["grad_avg"] = torch.zeros_like(p)
                    if momentum:
                        st["momentum_buffer"] = torch.zeros_like(p)
                st["step"] += 1
                sq = st["square_avg"]
                sq.mul_(alpha).add_((1.0 - alpha) * g.square())
                if group["centered"]:
                    ga = st["grad_avg"]
                    ga.mul_(alpha).add_((1.0 - alpha) * g)
                    denom = torch.sqrt(sq - ga.square() + eps)
                else:
                    denom = torch.sqrt(sq + eps)
                u = lr * g / denom
                if momentum:
                    buf = st["momentum_buffer"]
                    buf.mul_(momentum).add_(u)
                    u = buf
                p.sub_(u)


def rmsprop_tf(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-2,
    alpha: float = 0.99,
    eps: float = 1e-8,
    momentum: float = 0.0,
    centered: bool = False,
    **_: Any,
) -> torch.optim.Optimizer:
    return RMSpropTF(params, lr=lr, alpha=alpha, eps=eps, momentum=momentum, centered=centered)


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
