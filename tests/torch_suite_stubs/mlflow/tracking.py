"""``mlflow.tracking`` of the stand-in: ``MlflowClient`` over the recording
server of ``mlflow/__init__.py``."""
from types import SimpleNamespace

import mlflow


class MlflowClient:
    def __init__(self, tracking_uri=None):
        mlflow._record("MlflowClient", tracking_uri=tracking_uri)

    @staticmethod
    def _model(name):
        if name not in mlflow._STATE["models"]:
            raise mlflow.MlflowException(f"Registered Model with name={name} not found")
        return mlflow._STATE["models"][name]

    def get_registered_model(self, name):
        mlflow._record("get_registered_model", name=name)
        return SimpleNamespace(name=name, description=self._model(name)["description"])

    def update_registered_model(self, name, description=None):
        mlflow._record("update_registered_model", name=name, description=description)
        self._model(name)["description"] = description

    def _version(self, name, version):
        versions = self._model(name)["versions"]
        if int(version) not in versions:
            raise mlflow.MlflowException(f"Model Version (name={name}, version={version}) not found")
        return versions[int(version)]

    def update_model_version(self, name, version, description=None):
        mlflow._record("update_model_version", name=name, version=str(version), description=description)
        self._version(name, version)["description"] = description

    def get_latest_versions(self, name, stages=None):
        mlflow._record("get_latest_versions", name=name, stages=stages)
        latest = {}
        for v, entry in self._model(name)["versions"].items():
            latest[entry["stage"]] = max(v, latest.get(entry["stage"], 0))
        return [mlflow._version_obj(name, v) for v in sorted(latest.values())]

    def get_model_version(self, name, version):
        mlflow._record("get_model_version", name=name, version=str(version))
        self._version(name, version)
        return mlflow._version_obj(name, int(version))

    def transition_model_version_stage(self, name, version, stage, archive_existing_versions=False):
        mlflow._record("transition_model_version_stage", name=name, version=str(version), stage=stage)
        self._version(name, version)["stage"] = stage
        return mlflow._version_obj(name, int(version))

    def delete_model_version(self, name, version):
        mlflow._record("delete_model_version", name=name, version=str(version))
        self._version(name, version)
        del self._model(name)["versions"][int(version)]

    def get_experiment_by_name(self, name):
        mlflow._record("client.get_experiment_by_name", name=name)
        return mlflow._experiment(name)

    def search_runs(self, experiment_ids, filter_string="", max_results=1000):
        mlflow._record("search_runs", experiment_ids=list(experiment_ids))
        return [SimpleNamespace(info=SimpleNamespace(run_id=rid), data=SimpleNamespace(metrics=dict(r["metrics"])))
                for rid, r in sorted(mlflow._STATE["runs"].items()) if r["experiment_id"] in experiment_ids]

    def list_artifacts(self, run_id, path=None):
        mlflow._record("list_artifacts", run_id=run_id)
        import os

        root = os.path.join(mlflow._root(), run_id, "artifacts")
        names = sorted(os.listdir(root)) if os.path.isdir(root) else []
        return [SimpleNamespace(path=n, is_dir=os.path.isdir(os.path.join(root, n))) for n in names]

    def log_metric(self, run_id, key, value, step=None):
        mlflow._record("client.log_metric", run_id=run_id, key=key, value=value, step=step)
        mlflow._STATE["runs"][run_id]["metrics"][key] = value

    def get_model_version_download_uri(self, name, version):
        mlflow._record("get_model_version_download_uri", name=name, version=str(version))
        return self._version(name, version)["source"]
