from .models import (
    MLP,
    LayerNorm,
    LayerNormGRUCell,
    NatureCNN,
    get_activation,
    lecun_normal_,
    uniform_init_,
    variance_scaling_,
    xavier_normal_,
)

__all__ = [
    "MLP",
    "LayerNorm",
    "LayerNormGRUCell",
    "NatureCNN",
    "get_activation",
    "lecun_normal_",
    "uniform_init_",
    "variance_scaling_",
    "xavier_normal_",
]
