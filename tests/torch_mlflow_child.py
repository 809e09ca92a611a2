"""The MLflow checks of tests/test_torch_mlflow.py, run in a child
interpreter whose ``PYTHONPATH`` starts with ``tests/torch_suite_stubs``
(the recording ``mlflow`` stand-in; never on the pytest process's path).
One run takes one package, ``jax`` (``sheeprl_tpu``) or ``torch``
(``sheeprl_tpu_torch``), drives its MLflow model manager, ``publish_params``,
its MLflow logger and ``registration backend=mlflow`` through the same
scenarios, each on a fresh recording server, and pickles the server's call
log of each (and the published artifacts' contents) to ``out``.

    PYTHONPATH=tests/torch_suite_stubs:.:tests python tests/torch_mlflow_child.py torch out.pkl
"""
from __future__ import annotations

import importlib
import os
import pickle
import sys
from typing import Any, Dict

import numpy as np

from torch_suites_child import dig, error

# one world model, actor, critic, target critic and moments: a DreamerV3 checkpoint's groups
GROUPS = {name: {"w": np.arange(6, dtype=np.float32).reshape(2, 3) + i, "b": np.full(3, i, np.float32)}
          for i, name in enumerate(("wm", "actor", "critic", "target_critic"))}
MOMENTS = {"low": np.float32(-1.5), "high": np.float32(2.5)}


def _tensors(tree: Any) -> Any:
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _artifacts(root: str) -> Dict[str, Any]:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = dig(pickle.load(fh))
    return dict(sorted(out.items()))


def manager_scenario(pkg: str, mlflow: Any) -> Dict[str, Any]:
    reg = importlib.import_module(f"{pkg}.utils.mlflow_registry")
    models = {"ppo_env_agent": GROUPS["actor"], "ppo_env_critic": GROUPS["critic"]}
    if pkg == "sheeprl_tpu_torch":
        models = _tensors(models)
    manager = reg.MlflowModelManager()
    versions = reg.publish_params(manager, "ppo_run", models, specs={"ppo_env_critic": {"description": "critic",
                                                                                       "tags": {"k": "v"}}})
    again = reg.publish_params(manager, "ppo_run_2", {"ppo_env_agent": models["ppo_env_agent"]})
    mlflow.tracking.MlflowClient().log_metric("run-0001", "Test/cumulative_reward", 10.0)
    mlflow.tracking.MlflowClient().log_metric("run-0002", "Test/cumulative_reward", 20.0)
    latest = manager.get_latest_version("ppo_env_agent")
    staged = manager.transition_model("ppo_env_agent", 1, "Staging", description="promote")
    same = manager.transition_model("ppo_env_agent", 1, "staging")
    missing = manager.transition_model("nope", 3, "Production")
    best = manager.register_best_models("sheeprl_tpu", {"a": {"path": "ppo_env_agent", "name": "best_agent"},
                                                        "c": {"path": "ppo_env_critic", "name": "best_critic"}})
    best_min = manager.register_best_models("sheeprl_tpu", {"a": {"path": "ppo_env_agent", "name": "worst"}},
                                            mode="min")
    manager.download_model("ppo_env_agent", 2, "download")
    refused = error(lambda: manager.delete_model("ppo_env_critic", 1))
    manager.delete_model("ppo_env_critic", 1, description="gone", assume_yes=True)
    manager.delete_model("ppo_env_critic", 7, assume_yes=True)
    return {
        "versions": {k: v.version for k, v in versions.items()}, "again": again["ppo_env_agent"].version,
        "latest": latest.version, "staged": staged.current_stage, "same": same.current_stage, "missing": missing,
        "best": {k: [v.name, v.version] for k, v in best.items()}, "best_min": {k: v.name for k, v in best_min.items()},
        "bad_mode": error(lambda: manager.register_best_models("x", {}, mode="median")),
        "refused": refused, "download": _artifacts("download"),
        "no_uri": error(lambda: (os.environ.pop("MLFLOW_TRACKING_URI"), reg.MlflowModelManager())),
    }


def logger_scenario(pkg: str, mlflow: Any) -> Dict[str, Any]:
    config = importlib.import_module(f"{pkg}.config")
    logger_mod = importlib.import_module(f"{pkg}.utils.logger")
    node = {"type": "mlflow", "experiment_name": "ppo/CartPole-v1", "run_name": "mlrun", "tracking_uri": None,
            "tags": {"team": "rl"}}
    # about 900 flattened keys: three batches of at most 400 parameters
    extra = {f"group_{g}": {f"key_{k}": k * g for k in range(30)} for g in range(30)}
    cfg = config.Config({"metric": {"log_level": 1, "logger": node}, "root_dir": "ppo/CartPole-v1",
                         "run_name": "mlrun", "seed": 3, "extra": extra})
    logger = logger_mod.get_logger(cfg, "unused_log_dir", 0)
    logger.log_metrics({"Loss/a": np.float32(0.5), "Loss/b": 2, "text": "skipped", "arr": np.array(1.5)}, step=7)
    logger.log_metrics({"skipped": "only"}, step=8)
    run_id = logger.run_id
    logger.close()
    # the experiment and run names default to root_dir and run_name
    defaults = config.Config({"metric": {"log_level": 1, "logger": {"type": "mlflow"}}, "root_dir": "a/b",
                              "run_name": "r2"})
    logger_mod.get_logger(defaults, "unused_log_dir", 0).close()
    return {"run_id": run_id, "other_rank": logger_mod.get_logger(cfg, "unused_log_dir", 1),
            "silent": logger_mod.get_logger(config.Config({**cfg, "metric": {"log_level": 0, "logger": node}}), "x", 0),
            "type": type(logger).__name__}


def registration_scenario(pkg: str, mlflow: Any) -> Dict[str, Any]:
    import yaml

    cli = importlib.import_module(f"{pkg}.cli")
    run = os.path.join("logs", "runs", "dreamer_v3", "env", "version_0")
    os.makedirs(os.path.join(run, "checkpoint"))
    with open(os.path.join(run, "config.yaml"), "w") as f:
        yaml.safe_dump({"algo": {"name": "dreamer_v3"}, "env": {"id": "walker_walk"}, "exp_name": "dv3_walker"}, f)
    ckpt = os.path.join(run, "checkpoint", "ckpt_64.ckpt")
    if pkg == "sheeprl_tpu":
        with open(ckpt, "wb") as f:
            pickle.dump({"params": dict(GROUPS), "moments": dict(MOMENTS), "policy_step": 64}, f)
    else:
        import torch

        torch.save({**_tensors(GROUPS), "moments": _tensors(MOMENTS), "policy_step": 64}, ckpt)
    refused = error(lambda: cli.registration([f"checkpoint_path={ckpt}", "backend=mlflow", "model_manager.x=1"]))
    unknown = error(lambda: cli.registration([f"checkpoint_path={ckpt}", "backend=s3"]))
    cli.registration([f"checkpoint_path={ckpt}", "backend=mlflow"])
    return {"refused": refused, "unknown": unknown, "published": _artifacts("srv")}


def main(pkg_name: str, out_path: str) -> None:
    import mlflow

    pkg = {"jax": "sheeprl_tpu", "torch": "sheeprl_tpu_torch"}[pkg_name]
    if pkg == "sheeprl_tpu":
        importlib.import_module(pkg)  # the algorithm registry, which registration reads
    results = {}
    for name, fn in (("manager", manager_scenario), ("logger", logger_scenario),
                     ("registration", registration_scenario)):
        os.makedirs(name)
        os.chdir(name)
        os.environ["MLFLOW_TRACKING_URI"] = "file:srv"
        mlflow.reset()
        out = fn(pkg, mlflow)
        results[name] = {"result": out, "calls": [list(c) for c in mlflow.CALLS]}
        os.chdir("..")
    results["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "sheeprl_tpu"))
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
