"""Algorithm and evaluation registries (counterpart of
``sheeprl_tpu/utils/registry.py``): ``@register_algorithm`` records name →
training entry point, ``@register_evaluation`` name → evaluation entry
point; the CLI resolves ``cfg.algo.name`` through them."""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

algorithm_registry: Dict[str, Dict[str, Any]] = {}
evaluation_registry: Dict[str, Dict[str, Any]] = {}


def register_algorithm(name: Optional[str] = None, decoupled: bool = False,
                       requires_exploration_cfg: bool = False) -> Callable:
    """Register a training entry point ``main(cfg) -> None`` under ``name``
    (default: the name of the function's module's package, e.g.
    ``sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3`` → ``dreamer_v3``);
    ``decoupled`` algorithms need a player and a trainer device.
    ``requires_exploration_cfg`` marks a finetuning entry point
    ``main(cfg, exploration_cfg)``: the CLI loads the saved config of the
    exploration run whose checkpoint ``checkpoint.exploration_ckpt_path``
    names and passes it on (``cli.exploration_surgery``). The CLI launches
    every algorithm on ``fabric.devices`` ranks (``parallel/mesh.py``)."""

    def wrap(fn: Callable) -> Callable:
        key = name or fn.__module__.rsplit(".", 2)[-1]
        if key in algorithm_registry:
            raise ValueError(f"Algorithm '{key}' already registered")
        fn = _restores_process_switches(fn)
        algorithm_registry[key] = {"name": key, "module": fn.__module__, "entrypoint": fn.__name__, "fn": fn,
                                   "decoupled": bool(decoupled),
                                   "requires_exploration_cfg": bool(requires_exploration_cfg)}
        return fn

    return wrap


def _restores_process_switches(fn: Callable) -> Callable:
    """``fn`` with the process-wide switches a loop sets from its config
    (``MetricAggregator.disabled``, from ``metric.log_level``) put back to
    their prior values when the run ends, whether it returns or raises: a
    run leaves nothing behind for the next one in the same process."""
    from .metric import MetricAggregator

    @functools.wraps(fn)
    def run(*args: Any, **kwargs: Any) -> Any:
        prior = MetricAggregator.disabled
        try:
            return fn(*args, **kwargs)
        finally:
            MetricAggregator.disabled = prior

    return run


def register_evaluation(algorithms: Union[str, Sequence[str]]) -> Callable:
    """Register an evaluation entry point ``fn(cfg, state) -> None`` for the
    algorithm named ``algorithms``, or for each name of a list of them."""

    def wrap(fn: Callable) -> Callable:
        names: List[str] = [algorithms] if isinstance(algorithms, str) else list(algorithms)
        for key in names:
            if key in evaluation_registry:
                raise ValueError(f"Evaluation for '{key}' already registered")
            evaluation_registry[key] = {"name": key, "module": fn.__module__, "entrypoint": fn.__name__, "fn": fn}
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
