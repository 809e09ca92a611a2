"""The remote (MLflow) model registry (the port's own copy of
``sheeprl_tpu/utils/mlflow_registry.py``).

``MlflowModelManager`` registers, looks up, moves between stages, deletes,
picks the best run's models to register and downloads model versions on an
MLflow tracking server (``MLFLOW_TRACKING_URI`` or an explicit URI);
``registration checkpoint_path=... backend=mlflow`` publishes a checkpoint
split per the algorithm's ``MODELS_TO_REGISTER``. The local file registry
(``utils/model_manager.py``) stays the default.

Each group is published as its ``state_dict`` in numpy arrays, pickled
(``<model>/params.pkl``, an artifact of one MLflow run), exactly as the
local registry stores it, so it unpickles without torch. ``delete_model``
takes ``assume_yes`` in place of the reference's interactive prompt (the
prompt stays where stdin is a terminal). The MODEL CHANGELOG markdown
(version, transition and deletion entries appended to the registered model's
and the version's descriptions) is the JAX package's, so registries written
by either read the same.

``mlflow`` is imported when a manager is made: without it that raises
``ModuleNotFoundError``.
"""
from __future__ import annotations

import getpass
import os
import pathlib
import pickle
import sys
import tempfile
from datetime import datetime
from typing import Any, Dict, Literal, Optional

VERSION_MD_TEMPLATE = "## **Version {}**\n"
DESCRIPTION_MD_TEMPLATE = "### Description: \n{}\n"


def author_and_date_md() -> str:
    """A changelog entry's author and date."""
    stamp = datetime.now().astimezone().strftime("%d/%m/%Y %H:%M:%S %Z")
    return f"### Author: {getpass.getuser()}\n### Date: {stamp}\n"


def description_md(description: Optional[str]) -> str:
    return "" if description is None else DESCRIPTION_MD_TEMPLATE.format(description)


class MlflowModelManager:
    """Model versions' lifecycle on an MLflow tracking server."""

    def __init__(self, tracking_uri: Optional[str] = None):
        import mlflow

        self.tracking_uri = tracking_uri or os.getenv("MLFLOW_TRACKING_URI")
        if not self.tracking_uri:
            raise ValueError("No MLflow tracking URI: pass tracking_uri= or set MLFLOW_TRACKING_URI")
        mlflow.set_tracking_uri(self.tracking_uri)
        self._mlflow = mlflow
        self.client = mlflow.tracking.MlflowClient()

    # -- lifecycle ---------------------------------------------------------
    def register_model(self, model_location: str, model_name: str, description: Optional[str] = None,
                       tags: Optional[Dict[str, Any]] = None):
        """Register ``model_location`` (an artifact or run URI) as a new
        version of ``model_name``, with a MODEL CHANGELOG entry in both the
        registered model's and the version's descriptions."""
        version = self._mlflow.register_model(model_uri=model_location, name=model_name, tags=tags)
        print(f"Registered model {model_name} with version {version.version}")
        current = self.client.get_registered_model(model_name).description or ""
        header = "# MODEL CHANGELOG\n" if str(version.version) == "1" else ""
        entry = VERSION_MD_TEMPLATE.format(version.version) + author_and_date_md() + description_md(description)
        self.client.update_registered_model(model_name, header + current + entry)
        self.client.update_model_version(model_name, version.version, "# MODEL CHANGELOG\n" + entry)
        return version

    def get_latest_version(self, model_name: str):
        versions = self.client.get_latest_versions(model_name)
        if not versions:
            raise LookupError(f"Model '{model_name}' has no registered versions")
        return self.client.get_model_version(model_name, max(int(v.version) for v in versions))

    def transition_model(self, model_name: str, version: int, stage: str, description: Optional[str] = None):
        """Move a version to ``stage``, with the transition in both
        changelogs."""
        previous = self._safe_get_stage(model_name, version)
        if previous is None:
            return None
        if previous.lower() == str(stage).lower():
            print(f"Model {model_name} version {version} is already in stage {stage}")
            return self.client.get_model_version(model_name, version)
        print(f"Transitioning model {model_name} version {version} from {previous} to {stage}")
        mv = self.client.transition_model_version_stage(name=model_name, version=version, stage=stage)
        entry = (
            "## **Transition:**\n"
            f"### Version {mv.version} from {previous} to {mv.current_stage}\n"
            + author_and_date_md()
            + description_md(description)
        )
        self.client.update_registered_model(
            model_name, (self.client.get_registered_model(model_name).description or "") + entry
        )
        self.client.update_model_version(
            model_name, mv.version, (self.client.get_model_version(model_name, version).description or "") + entry
        )
        return mv

    def delete_model(self, model_name: str, version: int, description: Optional[str] = None,
                     assume_yes: bool = False) -> None:
        """Delete one version, after the model's name is typed back where
        stdin is a terminal; elsewhere only with ``assume_yes=True``: a
        confirmation that cannot be asked is never taken as given."""
        stage = self._safe_get_stage(model_name, version)
        if stage is None:
            return
        if not assume_yes:
            if not sys.stdin.isatty():
                raise RuntimeError(
                    f"refusing to delete model `{model_name}` version {version}: stdin "
                    "is not a terminal, so the name-confirmation prompt cannot run. "
                    "Pass assume_yes=True to delete without confirmation."
                )
            typed = input(
                f"Model named `{model_name}`, version {version} is in stage {stage}, "
                "type the model name to continue deletion:"
            )
            if typed != model_name:
                print("Model name did not match, aborting deletion")
                return
        print(f"Deleting model {model_name} version {version}")
        self.client.delete_model_version(model_name, version)
        entry = (
            "## **Deletion:**\n"
            f"### Version {version} from stage: {stage}\n"
            + author_and_date_md()
            + description_md(description)
        )
        self.client.update_registered_model(
            model_name, (self.client.get_registered_model(model_name).description or "") + entry
        )

    def register_best_models(self, experiment_name: str, models_info: Dict[str, Dict[str, Any]],
                             metric: str = "Test/cumulative_reward", mode: Literal["max", "min"] = "max"):
        """Register each of ``models_info``'s models that the experiment's
        best run on ``metric`` holds as an artifact."""
        if mode not in ("max", "min"):
            raise ValueError(f"Mode must be either 'max' or 'min', got {mode}")
        exp = self.client.get_experiment_by_name(experiment_name)
        runs = self.client.search_runs(experiment_ids=[exp.experiment_id]) if exp else []
        paths = [v["path"] for v in models_info.values()]
        best, best_artifacts = None, None
        for run in runs:
            arts = [a.path for a in self.client.list_artifacts(run.info.run_id) if a.path in paths]
            if not arts or run.data.metrics.get(metric) is None:
                continue
            if best is None or (
                run.data.metrics[metric] > best.data.metrics[metric]
                if mode == "max"
                else run.data.metrics[metric] < best.data.metrics[metric]
            ):
                best, best_artifacts = run, set(arts)
        if best is None:
            print(f"No runs found for experiment {experiment_name} with the given metric")
            return None
        out = {}
        for key, info in models_info.items():
            if info["path"] in best_artifacts:
                out[key] = self.register_model(
                    f"runs:/{best.info.run_id}/{info['path']}",
                    info["name"],
                    description=info.get("description"),
                    tags=info.get("tags"),
                )
        return out

    def download_model(self, model_name: str, version: int, output_path: str) -> None:
        """A version's artifacts into ``output_path``."""
        uri = self.client.get_model_version_download_uri(model_name, version)
        print(f"Downloading model {model_name} version {version} from {uri} to {output_path}")
        os.makedirs(output_path, exist_ok=True)
        self._mlflow.artifacts.download_artifacts(artifact_uri=uri, dst_path=output_path)

    # -- helpers -----------------------------------------------------------
    def _safe_get_stage(self, model_name: str, version: int) -> Optional[str]:
        try:
            return self.client.get_model_version(model_name, version).current_stage
        except Exception:  # noqa: BLE001 - the server's "no such version", whatever its class
            print(f"Model named {model_name} with version {version} does not exist")
            return None


def publish_params(manager: MlflowModelManager, run_name: str, models: Dict[str, Any],
                   specs: Optional[Dict[str, Dict[str, Any]]] = None,
                   experiment_name: str = "sheeprl_tpu") -> Dict[str, Any]:
    """Each of ``models`` (a module, a ``state_dict`` or a nested dict of
    tensors) as a pickled numpy artifact (``<name>/params.pkl``) of one new
    MLflow run, each registered as a model version. Returns {name:
    ModelVersion}."""
    from .model_manager import _to_host

    mlflow = manager._mlflow
    exp = mlflow.get_experiment_by_name(experiment_name)
    exp_id = mlflow.create_experiment(experiment_name) if exp is None else exp.experiment_id
    versions: Dict[str, Any] = {}
    with mlflow.start_run(experiment_id=exp_id, run_name=run_name) as run:
        with tempfile.TemporaryDirectory() as td:
            for name, params in models.items():
                sub = pathlib.Path(td) / name
                sub.mkdir()
                with open(sub / "params.pkl", "wb") as f:
                    pickle.dump(_to_host(params), f)
                mlflow.log_artifacts(str(sub), artifact_path=name)
        for name in models:
            spec = (specs or {}).get(name, {})
            versions[name] = manager.register_model(
                f"runs:/{run.info.run_id}/{name}",
                spec.get("model_name", name),
                description=spec.get("description"),
                tags=spec.get("tags"),
            )
    return versions


def register_models_from_checkpoint_remote(ckpt_path: pathlib.Path) -> None:
    """``registration checkpoint_path=... backend=mlflow``: the checkpoint
    split per the algorithm's MODELS_TO_REGISTER (the local registry's
    split), each group published to the MLflow registry."""
    from ..config import load_config_file
    from .checkpoint import CheckpointManager
    from .model_manager import _is_state_dict, _models_to_register, _resolve_model

    manager = MlflowModelManager()  # fail fast, before the (large) checkpoint load
    cfg = load_config_file(pathlib.Path(ckpt_path).parent.parent / "config.yaml")
    state = CheckpointManager.load(ckpt_path)
    algo_name = str(cfg.select("algo.name"))
    prefix = f"{algo_name}_{cfg.select('env.id')}"
    names = _models_to_register(algo_name)
    models: Dict[str, Any] = {}
    if names:
        for name in names:
            value = _resolve_model(name, state)
            if value is None:
                print(f"[registration] '{name}' not found in checkpoint {ckpt_path}; skipped")
                continue
            models[f"{prefix}_{name}"] = value
    else:
        models = {f"{prefix}_{k}": v for k, v in state.items() if _is_state_dict(v)}
    publish_params(manager, run_name=prefix, models=models, experiment_name=str(cfg.select("exp_name") or prefix))
