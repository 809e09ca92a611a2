"""Algorithm registry (the ``run`` half of ``sheeprl_tpu/utils/registry.py``):
``@register_algorithm`` records name → entry point; the CLI resolves
``cfg.algo.name`` through it."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

algorithm_registry: Dict[str, Dict[str, Any]] = {}


def register_algorithm(name: Optional[str] = None) -> Callable:
    """Register a training entry point ``main(cfg) -> None`` under ``name``
    (default: the name of the function's module's package, e.g.
    ``sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3`` → ``dreamer_v3``)."""

    def wrap(fn: Callable) -> Callable:
        key = name or fn.__module__.rsplit(".", 2)[-1]
        if key in algorithm_registry:
            raise ValueError(f"Algorithm '{key}' already registered")
        algorithm_registry[key] = {"name": key, "module": fn.__module__, "entrypoint": fn.__name__, "fn": fn}
        return fn

    return wrap


def get_algorithm(name: str) -> Dict[str, Any]:
    if name not in algorithm_registry:
        raise ValueError(f"Algorithm '{name}' is not registered. Available: {sorted(algorithm_registry)}")
    return algorithm_registry[name]
