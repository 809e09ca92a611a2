"""Local file-based model registry (the port's counterpart of
``sheeprl_tpu/utils/model_manager.py``).

The same lifecycle and layout as the JAX package's: each registered model
version is ``models_registry/<name>/v<N>/`` with ``params.pkl`` and
``meta.json`` (``name``, ``version``, ``description``, ``tags``,
``created_at``, ``stage``). ``params.pkl`` holds one group's ``state_dict``
as numpy arrays (bf16 tensors widened to float32, which loads back exactly),
so it unpickles without torch; ``download_model`` returns it as tensors,
what ``load_state_dict`` takes. ``register_model`` is the end-of-run hook of
the training loops (``model_manager.disabled=False``);
``register_models_from_checkpoint`` is ``registration checkpoint_path=...``.
"""
from __future__ import annotations

import json
import pathlib
import pickle
import time
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

# checkpoint keys that differ from the published model names
_PARAM_KEY_ALIASES = {"world_model": "wm"}


def _to_host(value: Any) -> Any:
    """A module, state_dict or nested dict of tensors → the same tree of
    numpy arrays."""
    if isinstance(value, torch.nn.Module):
        value = value.state_dict()
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    if isinstance(value, Mapping):
        return {k: _to_host(v) for k, v in value.items()}
    return value


def _to_tensors(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value)
    if isinstance(value, dict):
        return {k: _to_tensors(v) for k, v in value.items()}
    return value


class ModelManager:
    def __init__(self, registry_dir: str = "models_registry", disabled: bool = False):
        self.root = pathlib.Path(registry_dir)
        self.disabled = disabled

    def _versions(self, name: str) -> list:
        model_dir = self.root / name
        if not model_dir.is_dir():
            return []
        return sorted(int(p.name[1:]) for p in model_dir.iterdir() if p.is_dir() and p.name.startswith("v"))

    def register_model(self, name: str, params: Any, description: str = "", tags: Optional[Dict] = None) -> Optional[str]:
        if self.disabled:
            return None
        (self.root / name).mkdir(parents=True, exist_ok=True)
        versions = self._versions(name)
        version = (versions[-1] + 1) if versions else 1
        vdir = self.root / name / f"v{version}"
        vdir.mkdir()
        with open(vdir / "params.pkl", "wb") as f:
            pickle.dump(_to_host(params), f)
        meta = {
            "name": name,
            "version": version,
            "description": description,
            "tags": tags or {},
            "created_at": time.time(),
            "stage": "None",
        }
        with open(vdir / "meta.json", "w") as f:
            json.dump(meta, f, indent=2)
        return str(vdir)

    def get_latest_version(self, name: str) -> Optional[int]:
        versions = self._versions(name)
        return versions[-1] if versions else None

    def download_model(self, name: str, version: Optional[int] = None) -> Any:
        """The registered group as tensors: a ``state_dict`` for
        ``load_state_dict`` (or the dict of them a whole agent is)."""
        version = version or self.get_latest_version(name)
        if version is None:
            raise FileNotFoundError(f"No registered model '{name}'")
        with open(self.root / name / f"v{version}" / "params.pkl", "rb") as f:
            return _to_tensors(pickle.load(f))

    def transition_model(self, name: str, version: int, stage: str) -> None:
        meta_path = self.root / name / f"v{version}" / "meta.json"
        meta = json.loads(meta_path.read_text())
        meta["stage"] = stage
        meta_path.write_text(json.dumps(meta, indent=2))

    def delete_model(self, name: str, version: Optional[int] = None) -> None:
        import shutil

        target = self.root / name if version is None else self.root / name / f"v{version}"
        if target.exists():
            shutil.rmtree(target)


def register_model(cfg: Any, models: Dict[str, Any], log_dir: str) -> None:
    """End-of-training hook: register each of ``models`` (group name →
    module or state) as ``<algo>_<env>_<group>`` when the model manager is
    enabled; on N ranks, rank 0 alone registers (``parallel/mesh.py``)."""
    from ..parallel.mesh import active

    mm_cfg = cfg.select("model_manager") or {}
    run = active()
    if mm_cfg.get("disabled", True) or (run is not None and not run.is_global_zero):
        return
    manager = ModelManager()
    for name, params in models.items():
        spec = (mm_cfg.get("models") or {}).get(name, {}) or {}
        manager.register_model(
            f"{cfg.algo.name}_{cfg.env.id}_{name}",
            params,
            description=spec.get("description", ""),
            tags=spec.get("tags", {}),
        )


def registry_names(named: Mapping[str, Any]) -> Dict[str, Any]:
    """``named`` (keyed as a port checkpoint is) under the model registry's
    group names: the checkpoint's ``wm`` is ``world_model``."""
    published = {key: name for name, key in _PARAM_KEY_ALIASES.items()}
    return {published.get(k, k): v for k, v in named.items()}


def _models_to_register(algo_name: str) -> Optional[Sequence[str]]:
    """The algorithm's ``MODELS_TO_REGISTER``: looked up on the registered
    entry point's module first, then its package's ``utils``."""
    import importlib

    from .registry import get_algorithm

    try:
        entry = get_algorithm(algo_name)
    except ValueError:
        return None  # unknown algorithm: the caller registers the raw groups
    module = importlib.import_module(entry["module"])
    names = getattr(module, "MODELS_TO_REGISTER", None)
    if names is None:
        pkg = entry["module"].rsplit(".", 1)[0]
        try:
            names = getattr(importlib.import_module(f"{pkg}.utils"), "MODELS_TO_REGISTER", None)
        except ModuleNotFoundError:
            names = None
    return sorted(names) if names else None


def _is_state_dict(value: Any) -> bool:
    return isinstance(value, dict) and bool(value) and all(isinstance(v, torch.Tensor) for v in value.values())


def _resolve_model(name: str, state: Dict[str, Any]) -> Any:
    """One named group of a port checkpoint: ``agent`` is ``state['agent']``
    or, where the modules are saved apart, all of their state_dicts; else a
    top-level key (via aliases, world_model → wm), the ``<name>.`` entries
    of the agent's state_dict (sac_ae's encoder), or a nested split like
    moments_task → state['moments']['task']."""
    agent = state.get("agent")
    if name == "agent":
        if agent is not None:
            return agent
        groups = {k: v for k, v in state.items() if _is_state_dict(v)}
        return groups or None
    key = _PARAM_KEY_ALIASES.get(name, name)
    if key in state:
        return state[key]
    if _is_state_dict(agent):
        prefix = f"{key}."
        sub = {k[len(prefix):]: v for k, v in agent.items() if k.startswith(prefix)}
        if sub:
            return sub
    if "_" in name:
        head, rest = name.split("_", 1)
        node = state.get(head)
        if isinstance(node, dict) and rest in node:
            return node[rest]
    return None


def register_models_from_checkpoint(ckpt_path: pathlib.Path, overrides: Sequence[str] = ()) -> None:
    """``registration checkpoint_path=...``: split the checkpoint into the
    algorithm's MODELS_TO_REGISTER groups and register each as its own
    versioned model (a DreamerV3 checkpoint gives world_model, actor,
    critic, target_critic and moments)."""
    from ..config import load_config_file
    from .checkpoint import CheckpointManager

    cfg = load_config_file(pathlib.Path(ckpt_path).parent.parent / "config.yaml")
    state = CheckpointManager.load(ckpt_path)
    manager = ModelManager()
    algo_name = str(cfg.select("algo.name"))
    prefix = f"{algo_name}_{cfg.select('env.id')}"
    names = _models_to_register(algo_name)
    if not names:
        for key, value in state.items():
            if _is_state_dict(value):
                manager.register_model(f"{prefix}_{key}", value)
        return
    for name in names:
        value = _resolve_model(name, state)
        if value is None:
            print(f"[registration] '{name}' not found in checkpoint {ckpt_path}; skipped")
            continue
        manager.register_model(f"{prefix}_{name}", value)
