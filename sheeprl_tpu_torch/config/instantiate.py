"""`_target_`-based object instantiation (Hydra `hydra.utils.instantiate` subset).

The port's own copy of ``sheeprl_tpu/config/instantiate.py``.

The reference instantiates optimizers, env wrappers, loggers, actor classes,
etc. from config (`_target_`/`_partial_` keys, e.g. reference
configs/env/default.yaml, dreamer_v3 agent.py:1136). This is the same
contract: a mapping with `_target_: pkg.mod.Obj` becomes `Obj(**rest)`;
`_partial_: true` returns `functools.partial(Obj, **rest)`. Nested mappings
with `_target_` are instantiated recursively unless `_recursive_: false`.
"""
from __future__ import annotations

import functools
import importlib
from typing import Any, Mapping


def locate(path: str) -> Any:
    """Import a dotted path to a class/function/attribute."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        obj = mod
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
        except AttributeError:
            break
        return obj
    raise ImportError(f"Cannot locate '{path}'")


def instantiate(node: Any, *args: Any, **kwargs: Any) -> Any:
    """Instantiate a `_target_` config node. Non-target nodes pass through."""
    if node is None:
        return None
    if not isinstance(node, Mapping) or "_target_" not in node:
        return node
    recursive = node.get("_recursive_", True)
    partial = node.get("_partial_", False)
    target = locate(node["_target_"])
    call_kwargs = {}
    for k, v in node.items():
        if k in ("_target_", "_partial_", "_recursive_", "_convert_"):
            continue
        if recursive and isinstance(v, Mapping) and "_target_" in v:
            v = instantiate(v)
        elif recursive and isinstance(v, list):
            v = [instantiate(x) if isinstance(x, Mapping) and "_target_" in x else x for x in v]
        call_kwargs[k] = v
    call_kwargs.update(kwargs)
    if partial:
        return functools.partial(target, *args, **call_kwargs)
    return target(*args, **call_kwargs)
