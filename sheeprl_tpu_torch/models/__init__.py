from .models import (
    MLP,
    LayerNorm,
    LayerNormGRUCell,
    uniform_init_,
    variance_scaling_,
    xavier_normal_,
)

__all__ = [
    "MLP",
    "LayerNorm",
    "LayerNormGRUCell",
    "uniform_init_",
    "variance_scaling_",
    "xavier_normal_",
]
