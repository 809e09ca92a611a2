"""The port's MLflow side (``utils/mlflow_registry.py``, ``MLflowLogger``
in ``utils/logger.py``, ``registration backend=mlflow``) held against the
JAX package's on a recording stand-in of ``mlflow``
(``tests/torch_suite_stubs/mlflow``), and the timer shim
(``utils/timer.py``).

The stand-in must never be importable in the pytest process (the JAX
package's own MLflow tests skip without mlflow), so the checks run in two
child interpreters, started together, one per package
(``tests/torch_mlflow_child.py``). Each scenario runs on a fresh recording
server; the two packages' call logs must be equal (the changelog entries'
dates aside): the model manager's register, transition, delete,
``register_best_models`` and download, with the published and downloaded
artifacts' names and contents; the logger's calls, its ~900 parameters in
400-key ``log_params`` batches among them; ``registration
checkpoint_path=... backend=mlflow`` through each CLI on a DreamerV3
checkpoint of each package's format, and its refusals."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import importlib.util
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import pytest

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.telemetry.spans import GLOBAL_TRACKER
from sheeprl_tpu_torch.utils.timer import timer

REPO = Path(__file__).resolve().parent.parent
STUBS = REPO / "tests" / "torch_suite_stubs"
DV3_GROUPS = ("actor", "critic", "moments", "target_critic", "world_model")


def _dateless(x):
    if isinstance(x, str):
        return re.sub(r"### Date: [^\n]*\n", "### Date: <date>\n", x)
    if isinstance(x, dict):
        return {k: _dateless(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_dateless(v) for v in x]
    return x


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    root = tmp_path_factory.mktemp("mlflow")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.pathsep.join([str(STUBS), str(REPO), str(REPO / "tests")]), JAX_PLATFORMS="cpu")
    procs = {}
    for pkg in ("jax", "torch"):
        (root / pkg).mkdir()
        procs[pkg] = subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_mlflow_child.py"), pkg,
                                       str(root / f"{pkg}.pkl")], cwd=root / pkg, env=env, stdin=subprocess.DEVNULL,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for pkg, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        with open(root / f"{pkg}.pkl", "rb") as f:
            out[pkg] = _dateless(pickle.load(f))
    return out


@pytest.mark.parametrize("scenario", ["manager", "logger", "registration"])
def test_calls_match_the_jax_packages(seen, scenario):
    port, jax_side = seen["torch"][scenario], seen["jax"][scenario]
    assert port["calls"] == jax_side["calls"]
    assert port["result"] == jax_side["result"]
    assert port["calls"], scenario


def test_the_manager_lifecycle(seen):
    got = seen["torch"]["manager"]["result"]
    assert got["versions"] == {"ppo_env_agent": "1", "ppo_env_critic": "1"} and got["latest"] == "2"
    assert got["staged"] == got["same"] == "Staging" and got["missing"] is None
    assert got["best"] == {"a": ["best_agent", "1"]} and got["best_min"] == {"a": "worst"}
    assert got["refused"][0] == "RuntimeError" and "assume_yes=True" in got["refused"][1]
    assert list(got["download"]) == ["ppo_env_agent/params.pkl"]
    assert got["no_uri"][0] == "ValueError"
    calls = [c[0] for c in seen["torch"]["manager"]["calls"]]
    assert calls.count("delete_model_version") == 1 and calls.count("transition_model_version_stage") == 1
    changelog = next(c[1]["description"] for c in seen["torch"]["manager"]["calls"]
                     if c[0] == "update_registered_model" and "Deletion" in (c[1]["description"] or ""))
    assert changelog.startswith("# MODEL CHANGELOG\n## **Version 1**\n") and "### Description: \ngone\n" in changelog


def test_publish_params_artifact_names(seen):
    for pkg in ("jax", "torch"):
        logged = [(c[1]["artifact_path"], c[1]["files"]) for c in seen[pkg]["manager"]["calls"]
                  if c[0] == "log_artifacts"]
        assert logged == [("ppo_env_agent", ["params.pkl"]), ("ppo_env_critic", ["params.pkl"]),
                          ("ppo_env_agent", ["params.pkl"])]


def test_logger_batches_the_parameters(seen):
    calls = seen["torch"]["logger"]["calls"]
    batches = [len(c[1]["params"]) for c in calls if c[0] == "log_params"]
    assert batches[:3] == [400, 400, 109] and max(batches) <= 400
    metrics = next(c[1] for c in calls if c[0] == "log_metrics")
    assert metrics == {"metrics": {"Loss/a": 0.5, "Loss/b": 2.0, "arr": 1.5}, "step": 7}
    assert [c[0] for c in calls].count("log_metrics") == 1, "a batch of no scalar is not sent"
    assert ["set_tags", {"tags": {"team": "rl"}}] in calls
    assert ["set_experiment", {"experiment_name": "a/b"}] in calls  # root_dir by default
    got = seen["torch"]["logger"]["result"]
    assert got["type"] == "MLflowLogger" and got["other_rank"] is None and got["silent"] is None


def test_registration_backend_mlflow_publishes_each_group(seen):
    got = seen["torch"]["registration"]["result"]
    assert got["refused"][0] == "ValueError" and "does not accept extra overrides" in got["refused"][1]
    assert got["unknown"][0] == "ValueError" and "Unknown registration backend" in got["unknown"][1]
    published = sorted(p.split("/")[2] for p in got["published"])
    assert published == [f"dreamer_v3_walker_walk_{g}" for g in DV3_GROUPS]
    registered = [c[1]["name"] for c in seen["torch"]["registration"]["calls"] if c[0] == "register_model"]
    assert sorted(registered) == [f"dreamer_v3_walker_walk_{g}" for g in DV3_GROUPS]
    assert ["get_experiment_by_name", {"name": "dv3_walker"}] in seen["torch"]["registration"]["calls"]


def test_children_loaded_no_jax_in_the_port_and_no_stand_in_here(seen):
    assert seen["torch"]["loaded"] == [] and seen["jax"]["loaded"]
    assert importlib.util.find_spec("mlflow") is None, "the stand-in leaked into the pytest process"


def test_logger_mlflow_composes_as_the_jax_packages():
    over = ["exp=ppo", "logger@metric.logger=mlflow", "run_name=r"]
    assert compose("config", over).metric.logger.to_dict() == jax_compose("config", over).metric.logger.to_dict()


def test_without_mlflow_the_logger_and_the_registry_raise():
    from sheeprl_tpu_torch.config import Config
    from sheeprl_tpu_torch.utils.logger import get_logger
    from sheeprl_tpu_torch.utils.mlflow_registry import MlflowModelManager

    cfg = Config({"metric": {"log_level": 1, "logger": {"type": "mlflow"}}, "root_dir": "a", "run_name": "r"})
    with pytest.raises(ModuleNotFoundError, match="mlflow"):
        get_logger(cfg, "unused", 0)
    with pytest.raises(ModuleNotFoundError, match="mlflow"):
        MlflowModelManager("file:unused")


@pytest.mark.parametrize("disabled", [False, True])
def test_timer_shim_follows_metric_disable_timer(disabled):
    from sheeprl_tpu_torch import cli

    timer.disabled = not disabled
    cli.run(["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "dry_run=True", "env.num_envs=2",
             "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.run_test=False", "metric.log_level=0",
             f"metric.disable_timer={disabled}"])
    assert timer.disabled is disabled
    GLOBAL_TRACKER.reset()
    with timer("Time/shim"):
        pass
    assert ("Time/shim" in timer.compute(reset=True)) is not disabled
    assert timer.compute() == {}
    timer.disabled = False
