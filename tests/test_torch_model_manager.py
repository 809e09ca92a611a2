"""The port's model registry (sheeprl_tpu_torch/utils/model_manager.py) held
against the JAX package's: the same lifecycle on the same values gives the
same ``models_registry/<name>/v<N>/`` layout and ``meta.json`` fields (the
creation time aside), ``params.pkl`` unpickles to the same numpy arrays and
without torch; with ``model_manager.disabled=False`` the PPO and DreamerV3
loops register their groups at the end of a CPU run; ``registration
checkpoint_path=...`` splits a port checkpoint into its algorithm's
``MODELS_TO_REGISTER`` groups (the JAX package's, algorithm by algorithm),
and a download loads back into fresh modules that give the checkpoint's
outputs; ``backend=mlflow`` (tests/test_torch_mlflow.py) takes no other
argument and, without the mlflow package, raises."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import contextlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sheeprl_tpu  # noqa: F401 - registers the JAX package's algorithms
from sheeprl_tpu.utils import model_manager as jax_mm
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils import model_manager as mm
from test_torch_fleet import COMMON, DV3

REPO = Path(__file__).resolve().parent.parent


def _tree(root: Path):
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = p.relative_to(root).as_posix()
            if p.name == "meta.json":
                meta = json.loads(p.read_text())
                assert isinstance(meta.pop("created_at"), float)
                out[rel] = meta
            else:
                with open(p, "rb") as fh:
                    out[rel] = pickle.load(fh)
    return out


def _lifecycle(manager, params, tensors):
    manager.register_model("ppo_env_agent", params(), description="first", tags={"k": "v"})
    manager.register_model("ppo_env_agent", params())
    manager.register_model("ppo_env_critic", params())
    manager.transition_model("ppo_env_agent", 2, "Production")
    manager.register_model("ppo_env_agent", params())
    manager.delete_model("ppo_env_agent", 1)
    manager.delete_model("ppo_env_critic")
    assert manager.get_latest_version("ppo_env_agent") == 3 and manager.get_latest_version("nope") is None
    got = manager.download_model("ppo_env_agent", 2)
    return {k: np.asarray(v) for k, v in got.items()} if tensors else got


def test_lifecycle_layout_and_meta_match_the_jax_model_manager(tmp_path):
    rng = np.random.default_rng(0)
    values = {"fc.weight": rng.standard_normal((3, 4)).astype(np.float32),
              "fc.bias": rng.standard_normal(3).astype(np.float32), "steps": np.array(7, np.int64)}
    port_dl = _lifecycle(mm.ModelManager(str(tmp_path / "port")),
                         lambda: {k: torch.from_numpy(v.copy()) for k, v in values.items()}, tensors=True)
    jax_dl = _lifecycle(jax_mm.ModelManager(str(tmp_path / "jax")), lambda: dict(values), tensors=False)
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert list(port) == list(ref) == ["ppo_env_agent/v2/meta.json", "ppo_env_agent/v2/params.pkl",
                                       "ppo_env_agent/v3/meta.json", "ppo_env_agent/v3/params.pkl"]
    for rel in port:
        if rel.endswith("meta.json"):
            assert port[rel] == ref[rel]
        else:
            assert port[rel].keys() == ref[rel].keys()
            assert all(type(port[rel][k]) is np.ndarray and np.array_equal(port[rel][k], ref[rel][k])
                       for k in port[rel])
    assert port["ppo_env_agent/v2/meta.json"]["stage"] == "Production"
    assert all(np.array_equal(port_dl[k], jax_dl[k]) for k in values)
    with pytest.raises(FileNotFoundError):
        mm.ModelManager(str(tmp_path / "port")).download_model("nope")


def test_params_pkl_unpickles_without_torch_and_bf16_loads_back_exactly(tmp_path):
    module = torch.nn.Linear(4, 3).to(torch.bfloat16)
    vdir = mm.ModelManager(str(tmp_path)).register_model("m", module)
    code = ("import sys, pickle; sys.modules['torch'] = None\n"
            f"d = pickle.load(open({str(Path(vdir) / 'params.pkl')!r}, 'rb'))\n"
            "print(sorted(d), d['weight'].dtype)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.split() == ["['bias',", "'weight']", "float32"]
    fresh = torch.nn.Linear(4, 3).to(torch.bfloat16)
    fresh.load_state_dict(mm.ModelManager(str(tmp_path)).download_model("m"))
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), module.state_dict().values()))


# the JAX package's 15 single-device loops that register models at the end of a run
END_OF_RUN = ("a2c", "dreamer_v1", "dreamer_v2", "dreamer_v3", "droq", "p2e_dv1_exploration", "p2e_dv1_finetuning",
              "p2e_dv2_exploration", "p2e_dv2_finetuning", "p2e_dv3_exploration", "p2e_dv3_finetuning", "ppo",
              "ppo_recurrent", "sac", "sac_ae")
# the loops that call register_model themselves (the Dreamer V1/V2 and P2E loops
# register what their LoopParts give, held by the runs below)
DIRECT = ("a2c", "dreamer_v3", "droq", "ppo", "ppo_recurrent", "sac", "sac_ae")


def _end_of_run_groups(package: str, algo: str):
    """The group names of the literal dict an algorithm's loop hands to
    ``register_model`` at the end of a run."""
    src = (REPO / package / "algos" / algo.split("_exploration")[0].split("_finetuning")[0] / f"{algo}.py").read_text()
    call = src[src.index("register_model(", src.index("model_manager.disabled") if package == "sheeprl_tpu" else 0):]
    call = call[call.index("{"):call.index("log_dir")]
    depth, top = 0, []
    for m in re.finditer(r'[{}]|"(\w+)":', call):  # the dict's own keys, not those of a nested dict
        depth += {"{": 1, "}": -1}.get(m.group(0), 0)
        if m.group(1) and depth == 1:
            top.append(m.group(1))
    return sorted(top)


def test_models_to_register_and_end_of_run_groups_are_the_jax_packages():
    cli._register()
    for algo in END_OF_RUN + ("sac_decoupled",):
        assert mm._models_to_register(algo) == jax_mm._models_to_register(algo), algo
    # the JAX loops' end-of-run register_model calls: the same groups, loop by loop
    for algo in DIRECT:
        assert _end_of_run_groups("sheeprl_tpu_torch", algo) == _end_of_run_groups("sheeprl_tpu", algo), algo


def _last_ckpt(log_dir: Path) -> Path:
    return max((log_dir / "checkpoint").glob("ckpt_*.ckpt"), key=lambda p: int(p.stem.split("_")[1]))


def _run(args, tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run(args)
    return Path(next(l.split("=", 1)[1] for l in buf.getvalue().splitlines() if "] log_dir=" in l))


PPO = ["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "env.num_envs=4", "algo.rollout_steps=16",
       "algo.per_rank_batch_size=32", "algo.update_epochs=1", "algo.total_steps=128", "buffer.memmap=False",
       "algo.run_test=False", "checkpoint.every=64"]


def test_ppo_end_of_run_and_registration_from_its_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    log_dir = _run(PPO + ["model_manager.disabled=False", "run_name=ppo"], tmp_path)
    manager = mm.ModelManager()
    assert sorted(os.listdir("models_registry")) == ["ppo_discrete_dummy_agent"]
    ckpt = _last_ckpt(log_dir)
    state = torch.load(ckpt, map_location="cpu", weights_only=False)
    end = manager.download_model("ppo_discrete_dummy_agent", 1)
    assert end.keys() == state["agent"].keys() and all(torch.equal(end[k], state["agent"][k]) for k in end)
    cli.COMMANDS["registration"]([f"checkpoint_path={ckpt}"])
    assert manager.get_latest_version("ppo_discrete_dummy_agent") == 2
    with pytest.raises(ModuleNotFoundError, match="mlflow"):
        cli.COMMANDS["registration"]([f"checkpoint_path={ckpt}", "backend=mlflow"])
    with pytest.raises(ValueError, match="backend=mlflow does not accept extra overrides"):
        cli.COMMANDS["registration"]([f"checkpoint_path={ckpt}", "backend=mlflow", "seed=1"])
    with pytest.raises(ValueError, match="checkpoint_path"):
        cli.COMMANDS["registration"]([])


def test_dreamer_v3_end_of_run_and_registered_modules_act_as_the_checkpoint(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _actions_dim, make_player
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.config import load_config_file
    from sheeprl_tpu_torch.utils.env import single_env

    monkeypatch.chdir(tmp_path)
    log_dir = _run(DV3 + COMMON + ["model_manager.disabled=False", "run_name=dv3"], tmp_path)
    prefix = "dreamer_v3_discrete_dummy_"
    groups = _end_of_run_groups("sheeprl_tpu", "dreamer_v3")
    assert sorted(os.listdir("models_registry")) == [prefix + g for g in groups]
    ckpt = _last_ckpt(log_dir)
    cli.COMMANDS["registration"]([f"checkpoint_path={ckpt}"])
    manager = mm.ModelManager()
    assert {g: manager.get_latest_version(prefix + g) for g in groups} == {g: 2 for g in groups}
    state = torch.load(ckpt, map_location="cpu", weights_only=False)
    moments = manager.download_model(prefix + "moments")
    assert torch.equal(moments["low"], state["moments"]["low"]) and torch.equal(moments["high"],
                                                                                 state["moments"]["high"])
    cfg = load_config_file(log_dir / "config.yaml")
    env = single_env(cfg, 3)
    dims = _actions_dim(env.action_space)
    acts = {}
    # each side starts from other random weights: only what it loads can make them agree
    for name, seed, (wm_sd, actor_sd) in (("checkpoint", 99, (state["wm"], state["actor"])),
                                          ("registry", 100, (manager.download_model(prefix + "world_model"),
                                                             manager.download_model(prefix + "actor")))):
        torch.manual_seed(seed)
        wm, actor, _, _ = build_agent(cfg, env.observation_space, dims, False, torch.device("cpu"))
        wm.load_state_dict(wm_sd)
        actor.load_state_dict(actor_sd)
        init, step = make_player(wm, actor, cfg, dims, False, 1)
        obs, _ = env.reset(seed=3)
        gen = torch.Generator().manual_seed(5)
        act, _, s = step(prepare_obs(obs, tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder), 1),
                         init(), generator=gen)
        acts[name] = (act, *s)
    assert all(torch.equal(a, b) for a, b in zip(acts["checkpoint"], acts["registry"]))


def _shared_loop_args(family):
    from test_torch_dreamer_v1 import RUN as DV1_RUN
    from test_torch_dreamer_v2 import RUN as DV2_RUN
    from test_torch_p2e_dv1 import RUN as P2E_DV1_RUN
    from test_torch_p2e_dv2 import RUN as P2E_DV2_RUN
    from torch_p2e import TINY_DV3

    return {"dreamer_v1": DV1_RUN, "dreamer_v2": DV2_RUN, "p2e_dv1": P2E_DV1_RUN, "p2e_dv2": P2E_DV2_RUN,
            "p2e_dv3": TINY_DV3 + ["fabric.accelerator=cpu", "env.num_envs=2", "buffer.memmap=False",
                                   "algo.per_rank_sequence_length=2"]}[family]


@pytest.mark.parametrize("family", ["dreamer_v1", "dreamer_v2", "p2e_dv1", "p2e_dv2", "p2e_dv3"])
def test_shared_dreamer_loops_register_the_jax_groups(family, tmp_path, monkeypatch):
    """The loops on a shared ``run_serial`` (Dreamer V1/V2, and each P2E
    phase) register what their ``LoopParts`` give: the JAX loop's groups."""
    monkeypatch.chdir(tmp_path)
    args = _shared_loop_args(family) + ["dry_run=True", "algo.run_test=False", "metric.log_level=0",
                                        "model_manager.disabled=False"]
    if family.startswith("dreamer"):
        phases = [family]
        cli.run(args + ["run_name=r"])
    else:
        phases = [f"{family}_exploration", f"{family}_finetuning"]
        cli.run([f"exp={phases[0]}", *args, "run_name=ex"])
        (env_dir,) = (tmp_path / "logs" / "runs" / phases[0]).iterdir()
        cli.run([f"exp={phases[1]}", *args, "run_name=ft",
                 f"checkpoint.exploration_ckpt_path={_last_ckpt(env_dir / 'ex' / 'version_0')}"])
    want = []
    for algo in phases:
        (env_dir,) = (tmp_path / "logs" / "runs" / algo).iterdir()
        want += [f"{algo}_{env_dir.name}_{g}" for g in _end_of_run_groups("sheeprl_tpu", algo)]
    assert sorted(os.listdir("models_registry")) == sorted(want)


def test_resolve_model_splits_port_checkpoints():
    agent = {"encoder.fc.weight": torch.ones(2), "decoder.fc.weight": torch.zeros(2), "log_alpha": torch.ones(())}
    state = {"agent": agent, "opt_states": {"x": 1}}
    assert mm._resolve_model("agent", state) is agent
    assert mm._resolve_model("encoder", state) == {"fc.weight": agent["encoder.fc.weight"]}
    assert mm._resolve_model("nothing", state) is None
    dv = {"wm": {"a": torch.ones(1)}, "actor": {"b": torch.ones(1)}, "moments": {"task": {"low": 1}},
          "opt_states": {"wm": {}}, "policy_step": 3}
    assert mm._resolve_model("world_model", dv) is dv["wm"]
    assert mm._resolve_model("moments_task", dv) == {"low": 1}
    assert mm._resolve_model("agent", dv) == {"wm": dv["wm"], "actor": dv["actor"]}
