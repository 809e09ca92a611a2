"""Stand-in for MLflow 2.x: a recording tracking server in the process.

Mirrors the calls the two packages' loggers and registries make:
``set_tracking_uri``, ``set_experiment``, ``get_experiment_by_name``,
``create_experiment``, ``start_run`` (a context manager whose
``info.run_id`` names the run), ``end_run``, ``set_tags``, ``log_metrics``
(``step=``), ``log_params`` (refused above 500 keys, as MLflow refuses a
batch), ``log_artifacts``, ``register_model``, ``tracking.MlflowClient``
(``get_registered_model``, ``update_registered_model``,
``update_model_version``, ``get_latest_versions``, ``get_model_version``,
``transition_model_version_stage``, ``delete_model_version``,
``get_experiment_by_name``, ``search_runs``, ``list_artifacts``,
``log_metric``, ``get_model_version_download_uri``) and
``artifacts.download_artifacts``.

Every call is appended, in order, to ``CALLS`` as ``[name, arguments]``
(JSON-able; a logged directory as its sorted file list). Artifacts are
written under ``<tracking uri>/<run id>/artifacts`` (a ``file:`` or plain
path; ``./mlruns`` where none is set). Run ids are ``run-0001``,
``run-0002``, ... and experiment ids ``1``, ``2``, ...: deterministic, so
two clients that make the same calls see the same ids. ``reset()``
forgets everything.
"""
import os
import shutil
from types import SimpleNamespace

__version__ = "2.9.2-stand-in"
CALLS = []
_STATE = {}


def reset():
    CALLS.clear()
    _STATE.clear()
    _STATE.update(uri=None, experiments={}, active=None, runs={}, models={}, counter=0)


reset()


class MlflowException(Exception):
    pass


def _record(call, **kwargs):
    CALLS.append([call, kwargs])


def _root():
    uri = _STATE["uri"] or "mlruns"
    return uri[len("file:"):] if uri.startswith("file:") else uri


def _files(path):
    return sorted(os.path.relpath(os.path.join(d, f), path) for d, _, fs in os.walk(path) for f in fs)


def set_tracking_uri(uri):
    _record("set_tracking_uri", uri=str(uri))
    _STATE["uri"] = str(uri)


def get_tracking_uri():
    return _STATE["uri"]


def _experiment(name):
    exps = _STATE["experiments"]
    return SimpleNamespace(experiment_id=exps[name], name=name) if name in exps else None


def get_experiment_by_name(name):
    _record("get_experiment_by_name", name=name)
    return _experiment(name)


def create_experiment(name):
    _record("create_experiment", name=name)
    _STATE["experiments"][name] = str(len(_STATE["experiments"]) + 1)
    return _STATE["experiments"][name]


def set_experiment(experiment_name):
    _record("set_experiment", experiment_name=experiment_name)
    if experiment_name not in _STATE["experiments"]:
        _STATE["experiments"][experiment_name] = str(len(_STATE["experiments"]) + 1)
    _STATE["current_experiment"] = _STATE["experiments"][experiment_name]


class ActiveRun:
    def __init__(self, run_id):
        self.info = SimpleNamespace(run_id=run_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        end_run()
        return False


def start_run(run_id=None, experiment_id=None, run_name=None, **kwargs):
    _record("start_run", experiment_id=experiment_id, run_name=run_name)
    _STATE["counter"] += 1
    rid = f"run-{_STATE['counter']:04d}"
    exp = experiment_id or _STATE.get("current_experiment") or "0"
    _STATE["runs"][rid] = {"experiment_id": str(exp), "name": run_name, "metrics": {}, "params": {}, "tags": {}}
    _STATE["active"] = rid
    return ActiveRun(rid)


def end_run():
    _record("end_run")
    _STATE["active"] = None


def _active():
    if _STATE["active"] is None:
        raise MlflowException("no active run")
    return _STATE["runs"][_STATE["active"]]


def set_tags(tags):
    _record("set_tags", tags=dict(tags))
    _active()["tags"].update(tags)


def log_metrics(metrics, step=None):
    _record("log_metrics", metrics=dict(metrics), step=step)
    _active()["metrics"].update(metrics)


def log_params(params):
    _record("log_params", params={k: str(v) for k, v in params.items()})
    if len(params) > 500:
        raise MlflowException(f"A batch logging request can contain at most 500 params, got {len(params)}")
    _active()["params"].update(params)


def log_artifacts(local_dir, artifact_path=None):
    _record("log_artifacts", files=_files(local_dir), artifact_path=artifact_path)
    dst = os.path.join(_root(), _STATE["active"], "artifacts", artifact_path or "")
    shutil.copytree(local_dir, dst, dirs_exist_ok=True)


def _version_obj(name, v):
    entry = _STATE["models"][name]["versions"][v]
    return SimpleNamespace(name=name, version=str(v), current_stage=entry["stage"],
                           description=entry["description"], source=entry["source"], run_id=entry["run_id"])


def register_model(model_uri, name, tags=None):
    _record("register_model", model_uri=model_uri, name=name, tags=tags)
    model = _STATE["models"].setdefault(name, {"description": None, "versions": {}, "next": 1})
    v = model["next"]
    model["next"] += 1
    run_id = model_uri.split("/")[1] if model_uri.startswith("runs:/") else None
    model["versions"][v] = {"stage": "None", "description": None, "source": model_uri, "run_id": run_id,
                            "tags": tags}
    return _version_obj(name, v)


def _resolve(uri):
    if uri.startswith("runs:/"):
        rid, *path = uri[len("runs:/"):].split("/")
        return os.path.join(_root(), rid, "artifacts", *path)
    return uri


from . import artifacts, tracking  # noqa: E402
