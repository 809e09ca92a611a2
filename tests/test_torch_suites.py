"""The env suites of the port (Crafter, Super Mario Bros, DIAMBRA, MineDojo,
MineRL and its custom task specs) held against the JAX package's adapters
on stand-ins of the suites (``tests/torch_suite_stubs/``), which neither
this sandbox nor the card's machine has.

The stand-ins must never be importable in the pytest process (both
packages read their suite gates once, at import), so everything that needs
them runs in two child interpreters, started together, one per package
(``tests/torch_suites_child.py``), whose ``PYTHONPATH`` starts with the
stand-ins. Held bitwise, package against package, on the same seeds and
scripted actions across episode ends and resets: each adapter's
observations (keys, dtypes, bytes), rewards, terminated/truncated, infos,
renders, spaces (by ``low``, ``high``, ``shape``, ``dtype``, ``n``,
``nvec``), warnings and refusals; and ``vectorize`` of each new env config
with the whole wrapper stack (action repeat, frame stack, reward as
observation, resize and grayscale, time limit, the restarts of the
crash-prone suites, same-step autoreset). The port's child also dry-runs
each new preset through the CLI at cut widths and samples the MineDojo
actor under the env's masks. In the pytest process: each port adapter
raises the JAX package's message without its suite, video capture warns
as the JAX package does where no writer imports, ``RecordVideo`` writes
the episodes its trigger picks, and every module of the JAX package has a
counterpart in the port or a stated reason."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import importlib.util
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.utils import env as jenv
from sheeprl_tpu.utils import imports as jax_imports
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs.wrappers import GrayscaleRenderWrapper, RecordVideo
from sheeprl_tpu_torch.utils import env as tenv

REPO = Path(__file__).resolve().parent.parent
STUBS = REPO / "tests" / "torch_suite_stubs"
SUITE_NAMES = ("crafter", "gym", "gym_super_mario_bros", "nes_py", "diambra", "minedojo", "minerl", "mlflow")
PIPELINES = ("crafter", "super_mario_bros", "diambra", "minedojo", "minerl", "minerl_obtain_diamond",
             "minerl_obtain_iron_pickaxe")
NEW_PRESETS = ("dreamer_v3_XL_crafter", "dreamer_v3_L_navigate", "dreamer_v3_minedojo", "dreamer_v3_super_mario_bros",
               "dreamer_v2_crafter", "ppo_super_mario_bros")
# the JAX package's modules the port has no file for, and why
JAX_ONLY = {
    "ops/pallas_gru.py": "ported as ops/ln_gru.py and csrc/ln_gru.cu",
    "native/__init__.py": "ported as csrc/replay_gather.cpp (data/native.py)",
    "ops/conv_einsum.py": "XLA only: the CPU backend's convolution lowering",
    "telemetry/xla.py": "XLA only: compile and retrace counters",
    "utils/virtual_mesh.py": "XLA only: the host platform's virtual devices",
    "analysis/dataflow.py": "lint's JAX dataflow, left out on purpose",
    "analysis/jitsites.py": "lint's jit sites, left out on purpose",
    "analysis/rules/retrace.py": "lint's retrace rule, left out on purpose",
    "analysis/rules/donation.py": "lint's donation rule, left out on purpose",
}


def _child(pkg: str, out: Path, cwd: Path) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(STUBS), str(REPO), str(REPO / "tests")])
    env["JAX_PLATFORMS"] = "cpu"
    if pkg == "jax":
        env["SHEEPRL_TPU_LINT_LIGHT"] = "1"  # the adapters need no algorithm registry
    cwd.mkdir()
    return subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_suites_child.py"), pkg, str(out)], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    """What each package's child saw: {"jax": ..., "torch": ...}."""
    root = tmp_path_factory.mktemp("suites")
    procs = {pkg: _child(pkg, root / f"{pkg}.pkl", root / pkg) for pkg in ("jax", "torch")}
    out = {}
    for pkg, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        with open(root / f"{pkg}.pkl", "rb") as f:
            out[pkg] = pickle.load(f)
    return out


def _runs(result):
    """Every scripted episode run inside a suite's result."""
    if isinstance(result, dict):
        if "steps" in result and "reset" in result:
            yield result
        else:
            for v in result.values():
                yield from _runs(v)


def _ends(run):
    return [tuple(s[3:5]) for s in run["steps"] if s[0] != "reset" and (s[3] or s[4])]


@pytest.mark.parametrize("suite", ["crafter", "mario", "diambra", "minedojo", "minerl"])
def test_adapter_matches_the_jax_packages(seen, suite):
    jax_side, port = seen["jax"][suite], seen["torch"][suite]
    assert sorted(port) == sorted(jax_side)
    for key in jax_side:
        assert port[key] == jax_side[key], (suite, key)
    runs = list(_runs(port))
    assert runs and all(_ends(r) for r in runs), "every scripted run crosses an episode end and a reset"
    ends = {e for r in runs for e in _ends(r)}
    if suite in ("crafter", "mario", "minedojo", "minerl"):  # died and timed out both seen
        assert (True, False) in ends and (False, True) in ends, ends
    if suite == "crafter":
        assert port["bad_id"][0] == "AssertionError" and "'reward'" in port["bad_id"][1]
    if suite == "mario":
        assert [port[a]["spaces"][1]["n"] for a in ("right_only", "simple", "complex")] == [5, 7, 12]
    if suite == "diambra":
        case = port["MULTI_DISCRETE_True_4_False"]
        assert case["settings"]["step_ratio"] == 1 and case["wrappers"]["frame_shape"] == [48, 48, 1]
        assert case["wrappers"]["flatten"] is True and case["wrappers"]["repeat_action"] == 4
        assert sorted(case["warnings"]) == sorted([
            "The DIAMBRA frame_shape setting is disabled",
            "The DIAMBRA stack_frames wrapper is disabled", "The DIAMBRA flatten wrapper is disabled",
            "step_ratio parameter modified to 1 because the sticky action is active (4)"])
        assert port["DISCRETE_False_1_True"]["settings"]["frame_shape"] == [48, 48, 0]
        assert case["spaces"][0]["own_side"] == {"low": [0], "high": [1], "shape": (1,), "dtype": "<i4"}
        assert case["spaces"][0]["action"]["high"] == [8, 7] and case["spaces"][1]["nvec"] == [9, 8]
    if suite == "minedojo":
        run = port["harvest_milk"]["run"]
        taken = [s[5]["action"][0] for s in run["steps"] if s[0] != "reset"]
        assert set(taken) == set(range(19)), "every ACTION_MAP entry is taken"
        pitches = [s[5]["location_stats"]["pitch"] for s in run["steps"] if s[0] != "reset"]
        assert min(pitches) == -60.0 and max(pitches) == 60.0, "the pitch held at both limits"
        assert len(port["action_map"]) == 19 and port["bad_pitch"][0] == "ValueError"
    if suite == "minerl":
        assert port["tasks"] == {"custom_navigate": "CustomNavigate", "custom_obtain_diamond": "CustomObtainDiamond",
                                 "custom_obtain_iron_pickaxe": "CustomObtainIronPickaxe"}
        multihot = port["custom_obtain_diamond_True_True_True_100"]["spaces"][0]["inventory"]["shape"]
        flat = port["custom_obtain_diamond_True_True_False_100"]["spaces"][0]["inventory"]["shape"]
        assert multihot != flat and flat == (18,)


@pytest.mark.parametrize("config", PIPELINES)
def test_make_env_pipeline_matches_the_jax_packages(seen, config):
    port, jax_side = seen["torch"]["pipeline"][config], seen["jax"]["pipeline"][config]
    assert port == jax_side
    crash_prone = config.startswith(("diambra", "minedojo", "minerl"))
    assert (port["wrappers"][0] == "RestartOnException") == crash_prone
    assert any(any(s[2]) or any(s[3]) for s in port["steps"]) or config.startswith("minerl_obtain")


@pytest.mark.parametrize("exp", NEW_PRESETS)
def test_preset_dry_runs_on_the_stand_ins(seen, exp):
    run = seen["torch"]["presets"][exp]
    assert run["target"].startswith("sheeprl_tpu_torch.envs.") and run["ckpts"]
    want = "MinedojoActor" if exp == "dreamer_v3_minedojo" else None
    assert want is None or run["actor"].endswith(want)


def test_minedojo_actor_never_samples_a_masked_action(seen):
    got = seen["torch"]["minedojo_actor"]
    assert got["checked"] == 200 and not got["bad"]
    assert {15, 16, 17, 18} & set(got["types"]), "the masked heads were exercised"


def test_the_port_children_loaded_nothing_of_jax(seen):
    assert seen["torch"]["loaded"] == []


def test_dreamer_v2_crafter_composes_an_id_both_crafter_wrappers_refuse(seen):
    for cfg in (jax_compose("config", ["exp=dreamer_v2_crafter"]), compose("config", ["exp=dreamer_v2_crafter"])):
        assert cfg.env.id == "reward"
    assert seen["torch"]["crafter"]["bad_id"] == seen["jax"]["crafter"]["bad_id"]


ADAPTERS = [
    ("crafter", lambda m: m.CrafterWrapper("crafter_reward", 64), jax_imports._IS_CRAFTER_AVAILABLE),
    ("super_mario_bros", lambda m: m.SuperMarioBrosWrapper("SuperMarioBros-v0"),
     jax_imports._IS_SUPER_MARIO_BROS_AVAILABLE),
    ("diambra", lambda m: m.DiambraWrapper("doapp"), jax_imports._IS_DIAMBRA_AVAILABLE),
    ("minedojo", lambda m: m.MineDojoWrapper("open-ended"), jax_imports._IS_MINEDOJO_AVAILABLE),
    ("minerl", lambda m: m.MineRLWrapper("custom_navigate", dense=True, extreme=False),
     jax_imports._IS_MINERL_AVAILABLE),
    ("minerl_envs", lambda m: m.CUSTOM_TASKS, jax_imports._IS_MINERL_AVAILABLE),
]


@pytest.mark.parametrize("name,build,flag", ADAPTERS, ids=[a[0] for a in ADAPTERS])
def test_adapters_raise_the_jax_message_without_their_suite(name, build, flag):
    """The counterpart of tests/test_envs.py's gate test: the port's module
    imports, and building the adapter raises the JAX package's message."""
    assert not any(importlib.util.find_spec(s) for s in SUITE_NAMES), "a stand-in leaked into the pytest process"
    assert not flag
    mod = importlib.import_module(f"sheeprl_tpu_torch.envs.{name}")
    with pytest.raises(ModuleNotFoundError, match=re.escape(str(flag))):
        build(mod)


def test_capture_video_warns_and_steps_as_the_jax_package(tmp_path):
    over = ["exp=dreamer_v3", "env=dummy", "env.capture_video=True", "env.grayscale=True",
            "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"]
    for make, cfg in ((lambda c: tenv.make_env(c, 1, 0, 0, run_name=str(tmp_path / "t")), compose("config", over)),
                      (lambda c: jenv.make_env(c, 1, 0, str(tmp_path / "j")), jax_compose("config", over))):
        with pytest.warns(UserWarning, match="Video capture unavailable; continuing without RecordVideo"):
            env = make(cfg)()
        obs, _ = env.reset(seed=1)
        for _ in range(3):
            obs, *_ = env.step(env.action_space.sample())
        assert obs["rgb"].shape == (64, 64, 1)
        env.close()
    # rank 1, env 1 or no run dir: no video, no warning
    cfg = compose("config", over)
    for args in ((1, 0, str(tmp_path)), (0, 1, str(tmp_path)), (0, 0, None)):
        rank, idx, run = args
        env = tenv.make_env(cfg, 1, rank, idx, run_name=run)()
        assert type(env).__name__ == "RecordEpisodeStatistics"


def test_record_video_writes_the_episodes_its_trigger_picks(tmp_path):
    from sheeprl_tpu_torch.envs.dummy import DiscreteDummyEnv

    written = []
    env = RecordVideo(GrayscaleRenderWrapper(DiscreteDummyEnv(n_steps=3)), str(tmp_path / "videos"),
                      writer=lambda frames, path, fps: written.append((os.path.basename(path), len(frames), fps,
                                                                        frames[-1].shape, frames[-1][..., 0].tolist()
                                                                        == frames[-1][..., 2].tolist())))
    for _ in range(10):
        env.reset()
        done = False
        while not done:
            _, _, te, tr, _ = env.step(0)
            done = te or tr
    env.close()
    assert [w[0] for w in written] == ["rl-video-episode-0.mp4", "rl-video-episode-1.mp4", "rl-video-episode-8.mp4"]
    assert all(w[1] == 5 and w[2] == 30 and w[3] == (64, 64, 3) and w[4] for w in written)
    assert (tmp_path / "videos").is_dir()


def test_every_jax_module_has_a_port_counterpart_or_a_reason():
    jax_files = {p.relative_to(REPO / "sheeprl_tpu").as_posix() for p in (REPO / "sheeprl_tpu").rglob("*.py")}
    port_files = {p.relative_to(REPO / "sheeprl_tpu_torch").as_posix() for p in (REPO / "sheeprl_tpu_torch").rglob("*.py")}
    assert jax_files - port_files == set(JAX_ONLY)
    jax_cfgs = {p.relative_to(REPO / "sheeprl_tpu" / "configs").as_posix()
                for p in (REPO / "sheeprl_tpu" / "configs").rglob("*.yaml")}
    port_cfgs = {p.relative_to(REPO / "sheeprl_tpu_torch" / "configs").as_posix()
                 for p in (REPO / "sheeprl_tpu_torch" / "configs").rglob("*.yaml")}
    assert jax_cfgs - port_cfgs == set()
