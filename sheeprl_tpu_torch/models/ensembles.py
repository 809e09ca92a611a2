"""MLP ensembles for Plan2Explore's disagreement signal (counterpart of
``sheeprl_tpu/models/ensembles.py``).

The JAX package stacks ``n`` MLPs' parameters on a leading axis and applies
them in one ``jax.vmap``; here that is an ``EnsembleMLP``, whose weights
carry the leading ``n`` axis and whose layers are batched products
(``torch.baddbmm``). The members have no LayerNorm, as the JAX package
builds them (it passes no ``layer_norm`` to ``build_ensembles``, whatever
``algo.ensembles.layer_norm`` says).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .models import EnsembleLinear, EnsembleMLP


def build_ensembles(n: int, input_dim: int, output_dim: int, mlp_layers: int, dense_units: int,
                    activation: str, device=None) -> EnsembleMLP:
    """``n`` MLPs (``mlp_layers`` hidden layers of ``dense_units``, then a
    linear ``out`` head) as one ``EnsembleMLP``: ``ens(x)`` maps ``[..., in]``
    (shared by the members) to ``[n, ..., out]``. Each member's kernels are
    drawn apart, flax's lecun-normal from the torch global RNG, the biases
    zero."""
    ens = EnsembleMLP(n, input_dim, (dense_units,) * mlp_layers, output_dim, activation=activation)
    with torch.no_grad():
        for layer in ens.modules():
            if isinstance(layer, EnsembleLinear):
                std = math.sqrt(1.0 / max(1, layer.weight.shape[1])) / 0.87962566103423978
                for member in layer.weight:
                    nn.init.trunc_normal_(member, 0.0, std, -2 * std, 2 * std)
    return ens.to(device) if device is not None else ens


def apply_ensembles(ens: EnsembleMLP, x: torch.Tensor) -> torch.Tensor:
    """``[..., in]`` → ``[n, ..., out]``: the leading axes flattened for the
    batched products and restored after."""
    lead = x.shape[:-1]
    out = ens(x.reshape(-1, x.shape[-1]))
    return out.reshape(out.shape[0], *lead, out.shape[-1])
