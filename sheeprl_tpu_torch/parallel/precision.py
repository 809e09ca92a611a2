"""The precision policy table (the port's own copy of ``_PRECISION_POLICIES``,
``get_precision`` and ``cast_floating`` from ``sheeprl_tpu/parallel/mesh.py``).

``fabric.precision`` names a (parameter dtype, compute dtype) pair. There is
no fp16: it would need loss scaling, and bf16 is what the tensor cores take
without one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

_PRECISION_POLICIES = {
    # name: (param_dtype, compute_dtype)
    "32-true": (torch.float32, torch.float32),
    "bf16-mixed": (torch.float32, torch.bfloat16),
    "bf16-true": (torch.bfloat16, torch.bfloat16),
}


@dataclass
class Precision:
    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype


def get_precision(name: str) -> Precision:
    if name not in _PRECISION_POLICIES:
        raise ValueError(f"Unknown precision '{name}'. Options: {sorted(_PRECISION_POLICIES)}")
    p, c = _PRECISION_POLICIES[name]
    return Precision(name, p, c)


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of a nested tuple/list/dict to ``dtype``
    (integer, bool and non-tensor leaves pass through). The cast is
    differentiable: gradients reach the tensors it was given."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() and tree.dtype != dtype else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [cast_floating(v, dtype) for v in tree]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return tree


def disable_tf32() -> None:
    """f32 matmuls and convolutions in full f32 on the card: TF32 off for
    cuBLAS and cuDNN (PyTorch enables it for cuDNN by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
