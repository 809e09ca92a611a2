"""Algorithm and evaluation registries (counterpart of
``sheeprl_tpu/utils/registry.py``): ``@register_algorithm`` records name →
training entry point, ``@register_evaluation`` name → evaluation entry
point; the CLI resolves ``cfg.algo.name`` through them."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

algorithm_registry: Dict[str, Dict[str, Any]] = {}
evaluation_registry: Dict[str, Dict[str, Any]] = {}


def register_algorithm(name: Optional[str] = None, decoupled: bool = False) -> Callable:
    """Register a training entry point ``main(cfg) -> None`` under ``name``
    (default: the name of the function's module's package, e.g.
    ``sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3`` → ``dreamer_v3``);
    ``decoupled`` algorithms need a player and a trainer device."""

    def wrap(fn: Callable) -> Callable:
        key = name or fn.__module__.rsplit(".", 2)[-1]
        if key in algorithm_registry:
            raise ValueError(f"Algorithm '{key}' already registered")
        algorithm_registry[key] = {"name": key, "module": fn.__module__, "entrypoint": fn.__name__, "fn": fn,
                                   "decoupled": bool(decoupled)}
        return fn

    return wrap


def register_evaluation(algorithm: str) -> Callable:
    """Register an evaluation entry point ``fn(cfg, state) -> None`` for the
    algorithm named ``algorithm``."""

    def wrap(fn: Callable) -> Callable:
        if algorithm in evaluation_registry:
            raise ValueError(f"Evaluation for '{algorithm}' already registered")
        evaluation_registry[algorithm] = {"name": algorithm, "module": fn.__module__, "entrypoint": fn.__name__, "fn": fn}
        return fn

    return wrap


def get_algorithm(name: str) -> Dict[str, Any]:
    if name not in algorithm_registry:
        raise ValueError(f"Algorithm '{name}' is not registered. Available: {sorted(algorithm_registry)}")
    return algorithm_registry[name]


def get_evaluation(name: str) -> Dict[str, Any]:
    if name not in evaluation_registry:
        raise ValueError(f"No evaluation registered for '{name}'. Available: {sorted(evaluation_registry)}")
    return evaluation_registry[name]
