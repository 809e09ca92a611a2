"""The env-suite checks of tests/test_torch_suites.py, run in a child
interpreter whose ``PYTHONPATH`` starts with ``tests/torch_suite_stubs``
(never in the pytest process: the JAX package reads the suites' gates at
import). One run takes one package, ``jax`` (``sheeprl_tpu``) or ``torch``
(``sheeprl_tpu_torch``), puts each adapter of that package and its
``vectorize`` pipeline through the same scripted episodes on the
stand-ins, and pickles what it saw to ``out``: observation digests (dtype,
shape and a hash of the bytes, so equal digests are bitwise equal arrays),
rewards, terminated/truncated, infos, spaces by their attributes, warnings
and error messages. The port's run adds the CLI dry runs of the new
presets and the MineDojo actor's masked sampling.

    PYTHONPATH=tests/torch_suite_stubs:.:tests python tests/torch_suites_child.py torch out.pkl
"""
from __future__ import annotations

import hashlib
import importlib
import pickle
import sys
import warnings
from typing import Any, Callable, Dict, List

import numpy as np

STEPS = 90


def dig(x: Any) -> Any:
    """A comparable digest of an observation, info or action."""
    if isinstance(x, dict):
        return {str(k): dig(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [dig(v) for v in x]
    if isinstance(x, np.ndarray):
        if x.dtype.kind in "OUS":
            return ["strs", x.shape, [str(v) for v in x.reshape(-1)]]
        return [x.dtype.str, x.shape, hashlib.sha1(np.ascontiguousarray(x).tobytes()).hexdigest()]
    if isinstance(x, (np.bool_, bool)):
        return bool(x)
    if isinstance(x, (np.integer, int)):
        return int(x)
    if isinstance(x, (np.floating, float)):
        return float(x)
    if x is None or isinstance(x, str):
        return x
    return type(x).__name__


def space_desc(space: Any) -> Any:
    """A space by its attributes (never its class)."""
    if hasattr(space, "spaces") and isinstance(space.spaces, dict):
        return {k: space_desc(v) for k, v in space.spaces.items()}
    out: Dict[str, Any] = {}
    for attr in ("low", "high"):
        if hasattr(space, attr):
            out[attr] = np.asarray(getattr(space, attr)).tolist()
    if getattr(space, "shape", None) is not None:
        out["shape"] = tuple(int(d) for d in space.shape)
    if getattr(space, "dtype", None) is not None:
        out["dtype"] = np.dtype(space.dtype).str
    if hasattr(space, "nvec"):
        out["nvec"] = np.asarray(space.nvec).tolist()
    elif hasattr(space, "n"):
        out["n"] = int(space.n)
    return out


def error(fn: Callable[[], Any]) -> List[str]:
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - the message is what is compared
        return [type(err).__name__, str(err)]
    return ["no error"]


def episode(env: Any, act: Callable[[Dict[str, Any], int], Any], steps: int = STEPS, seed: Any = None,
            reset_seed: Any = None, render_every: int = 0) -> Dict[str, Any]:
    """Reset ``env`` (``seed``), then ``steps`` steps of ``act(obs, i)``,
    resetting (``reset_seed``) at every episode end."""
    obs, info = env.reset(seed=seed)
    rec: Dict[str, Any] = {"reset": [dig(obs), dig(info)], "steps": [], "renders": []}
    for i in range(steps):
        action = act(obs, i)
        obs, reward, terminated, truncated, info = env.step(action)
        rec["steps"].append([dig(action), dig(obs), float(reward), bool(terminated), bool(truncated), dig(info)])
        if render_every and i % render_every == 0:
            rec["renders"].append(dig(env.render()))
        if terminated or truncated:
            obs, info = env.reset(seed=reset_seed)
            rec["steps"].append(["reset", dig(obs), dig(info)])
    return rec


def ends(rec: Dict[str, Any]) -> List[List[bool]]:
    return [s[3:5] for s in rec["steps"] if s[0] != "reset" and (s[3] or s[4])]


# -- each suite ---------------------------------------------------------------------
def crafter_checks(pkg: str) -> Dict[str, Any]:
    import crafter

    mod = importlib.import_module(f"{pkg}.envs.crafter")
    out: Dict[str, Any] = {"bad_id": error(lambda: mod.CrafterWrapper("reward", 64, seed=0))}
    for length in (crafter.LENGTH, 25):
        crafter.LENGTH = length
        for cid in ("crafter_reward", "crafter_nonreward"):
            env = mod.CrafterWrapper(cid, screen_size=64, seed=7)
            rng = np.random.default_rng(0)
            out[f"{cid}_{length}"] = {
                "spaces": [space_desc(env.observation_space), space_desc(env.action_space)],
                "run": episode(env, lambda o, i: int(rng.integers(17)), seed=11, render_every=7),
            }
            env.close()
    crafter.LENGTH = 10000
    return out


def mario_checks(pkg: str) -> Dict[str, Any]:
    import gym_super_mario_bros

    mod = importlib.import_module(f"{pkg}.envs.super_mario_bros")
    out: Dict[str, Any] = {}
    gym_super_mario_bros.CLOCK = 45
    for aset in ("right_only", "simple", "complex"):
        env = mod.SuperMarioBrosWrapper("SuperMarioBros-v0", action_space=aset)
        rng = np.random.default_rng(1)
        n = env.action_space.n
        out[aset] = {
            "spaces": [space_desc(env.observation_space), space_desc(env.action_space)],
            "run": episode(env, lambda o, i: np.array(rng.integers(n)) if i % 2 else int(rng.integers(n)), seed=3,
                           render_every=11),
        }
        env.close()
    return out


DIAMBRA_SETTINGS = {"role": "P1", "step_ratio": 6, "difficulty": 4, "continue_game": 0.0, "show_final": False,
                    "outfits": 4, "splash_screen": False, "frame_shape": [1, 2, 3]}
DIAMBRA_WRAPPERS = {"stack_actions": 1, "no_op_max": 0, "no_attack_buttons_combinations": False,
                    "add_last_action": True, "scale": False, "exclude_image_scaling": False,
                    "process_discrete_binary": False, "role_relative": True, "stack_frames": 4, "flatten": False}


def _settings(obj: Any) -> Dict[str, Any]:
    import dataclasses

    return {k: (v.name if hasattr(v, "name") else list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(obj).items()}


def diambra_checks(pkg: str) -> Dict[str, Any]:
    mod = importlib.import_module(f"{pkg}.envs.diambra")
    out: Dict[str, Any] = {
        "bad_action_space": error(lambda: mod.DiambraWrapper("doapp", action_space="BOX")),
        "bad_role": error(lambda: mod.DiambraWrapper("doapp", diambra_settings={"role": "P3"})),
    }
    cases = [("DISCRETE", False, 1, True), ("MULTI_DISCRETE", True, 4, False), ("DISCRETE", True, 2, True)]
    for space, gray, repeat, perf in cases:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            env = mod.DiambraWrapper("doapp", action_space=space, screen_size=48, grayscale=gray, repeat_action=repeat,
                                     rank=2, diambra_settings=dict(DIAMBRA_SETTINGS),
                                     diambra_wrappers=dict(DIAMBRA_WRAPPERS), increase_performance=perf)
        arena = env.env
        rng = np.random.default_rng(2)

        def act(o, i, rng=rng, space=space):
            if space == "DISCRETE":
                a = int(rng.integers(16))
                return np.array([a]) if i % 2 else a
            return rng.integers(0, [9, 8])

        run = episode(env, act, seed=5, render_every=13)
        out[f"{space}_{gray}_{repeat}_{perf}"] = {
            "warnings": [str(w.message) for w in caught if "DIAMBRA" in str(w.message) or "step_ratio" in str(w.message)],
            "settings": _settings(arena.env_settings), "wrappers": _settings(arena.wrappers_settings),
            "spaces": [space_desc(env.observation_space), space_desc(env.action_space)],
            "render_mode": env.render_mode, "run": run,
        }
        env.close()
    return out


def minedojo_actions(mod: Any, rng: np.random.Generator):
    """An action under the env's masks: the first 19 steps walk the table in
    order, then sticky attack and jump with their cancels, then the pitch to
    both limits, then random allowed actions."""
    script = list(range(19)) + [14, 0, 0, 0, 12, 0, 5, 0, 0, 3, 0, 5, 2, 0] + [8] * 6 + [9] * 10 + [0]

    def act(obs, i):
        m_type = obs["mask_action_type"]
        allowed = np.flatnonzero(m_type)
        a0 = script[i] if i < len(script) else int(rng.choice(allowed))
        if not m_type[a0]:
            a0 = 0
        craft = np.flatnonzero(obs["mask_craft_smelt"])
        a1 = int(rng.choice(craft)) if len(craft) else 0
        item_mask = obs["mask_destroy"] if a0 == 18 else obs["mask_equip_place"]
        items = np.flatnonzero(item_mask)
        if a0 in (16, 17, 18) and not len(items):
            a0 = 0
        a2 = int(rng.choice(items)) if a0 in (16, 17, 18) else int(rng.integers(len(item_mask)))
        return np.array([a0, a1, a2])

    return act


def minedojo_checks(pkg: str) -> Dict[str, Any]:
    import minedojo

    mod = importlib.import_module(f"{pkg}.envs.minedojo")
    out: Dict[str, Any] = {
        "action_map": {k: v.tolist() for k, v in mod.ACTION_MAP.items()},
        "bad_pitch": error(lambda: mod.MineDojoWrapper("open-ended", seed=1,
                                                       start_position={"x": 0, "y": 0, "z": 0, "pitch": 80, "yaw": 0})),
    }
    for task, speed, max_steps in (("harvest_milk", 1, 70), ("open-ended", 100, 12)):
        minedojo.MAX_STEPS = max_steps
        env = mod.MineDojoWrapper(task, height=64, width=64, pitch_limits=(-60, 60), seed=5, sticky_attack=30,
                                  sticky_jump=10, break_speed_multiplier=speed, start_position=None)
        rng = np.random.default_rng(4)
        out[task] = {"spaces": [space_desc(env.observation_space), space_desc(env.action_space)],
                     "run": episode(env, minedojo_actions(mod, rng), steps=110, render_every=9)}
    minedojo.MAX_STEPS = 3000
    return out


def minerl_checks(pkg: str) -> Dict[str, Any]:
    import gym

    mod = importlib.import_module(f"{pkg}.envs.minerl")
    tasks_mod = importlib.import_module(f"{pkg}.envs.minerl_envs")
    out: Dict[str, Any] = {"tasks": {k: v.__name__ for k, v in tasks_mod.CUSTOM_TASKS.items()}}
    gym._REGISTRY["MineRLNavigateDense-v0"]["max_episode_steps"] = 30
    cases = [("custom_navigate", d, e, m, 100) for d in (True, False) for e in (True, False) for m in (True, False)]
    cases += [(t, d, True, m, s) for t in ("custom_obtain_diamond", "custom_obtain_iron_pickaxe")
              for d in (True, False) for m in (True, False) for s in (100, 1)]
    cases += [("MineRLNavigateDense-v0", True, False, True, 1)]
    for tid, dense, extreme, multihot, speed in cases:
        kw = {} if tid.startswith("MineRL") else {"dense": dense, "extreme": extreme}
        env = mod.MineRLWrapper(tid, height=64, width=64, pitch_limits=(-60, 60), seed=3, sticky_attack=30,
                                sticky_jump=10, break_speed_multiplier=speed, multihot_inventory=multihot, **kw)
        amap = env.ACTIONS_MAP
        cams = [k for k, v in amap.items() if "camera" in v]
        up = next(k for k in cams if amap[k]["camera"][0] > 0)
        down = next(k for k in cams if amap[k]["camera"][0] < 0)
        jump = next(k for k, v in amap.items() if "jump" in v)
        attack = next(k for k, v in amap.items() if "attack" in v)
        script = [up] * 6 + [down] * 10 + [attack, 0, 0, 0, jump, 0, 0] + [0] * 3
        rng = np.random.default_rng(5)
        n = env.action_space.n
        spec = getattr(env.env, "spec", None)
        out[f"{tid}_{dense}_{extreme}_{multihot}_{speed}"] = {
            "spec": getattr(spec, "name", None),
            "actions_map": dig(amap), "spaces": [space_desc(env.observation_space), space_desc(env.action_space)],
            "run": episode(env, lambda o, i: script[i] if i < len(script) else int(rng.integers(n)), steps=120,
                           render_every=10),
        }
        env.close()
    return out


# -- the whole pipeline: each env config through vectorize ----------------------------------------------
PIPELINES = {
    "crafter": ["env=crafter", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[reward]", "env.frame_stack=2",
                "env.action_repeat=2", "env.screen_size=32", "env.max_episode_steps=20"],
    "super_mario_bros": ["env=super_mario_bros", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]",
                         "env.grayscale=True", "env.action_repeat=3", "env.reward_as_observation=True"],
    "diambra": ["env=diambra", "algo.cnn_keys.encoder=[frame]", "algo.mlp_keys.encoder=[own_health,timer]",
                "env.action_repeat=2", "env.grayscale=True", "env.frame_stack=3", "env.screen_size=32"],
    "minedojo": ["env=minedojo", "algo.cnn_keys.encoder=[rgb]",
                 "algo.mlp_keys.encoder=[inventory,equipment,life_stats,mask_action_type]", "env.capture_video=False",
                 "env.max_episode_steps=25", "env.action_repeat=2"],
    "minerl": ["env=minerl", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[inventory,compass,reward]",
               "env.max_episode_steps=30", "env.frame_stack=2"],
    "minerl_obtain_diamond": ["env=minerl_obtain_diamond", "algo.cnn_keys.encoder=[rgb]",
                              "algo.mlp_keys.encoder=[inventory,equipment,max_inventory]", "env.grayscale=True",
                              "env.reward_as_observation=True"],
    "minerl_obtain_iron_pickaxe": ["env=minerl_obtain_iron_pickaxe", "algo.cnn_keys.encoder=[rgb]",
                                   "algo.mlp_keys.encoder=[life_stats,inventory]", "env.screen_size=48"],
}


def pipeline_checks(pkg: str) -> Dict[str, Any]:
    compose = importlib.import_module(f"{pkg}.config").compose
    env_mod = importlib.import_module(f"{pkg}.utils.env")
    out: Dict[str, Any] = {}
    for name, overrides in PIPELINES.items():
        cfg = compose("config", ["exp=dreamer_v3", *overrides, "env.num_envs=1", "env.sync_env=True", "seed=9"])
        envs = env_mod.vectorize(cfg, 9, 0)
        inner = envs.envs[0]
        wrappers = []
        while hasattr(inner, "env"):
            wrappers.append(type(inner).__name__)
            inner = inner.env
        obs, _ = envs.reset(seed=9)
        rng = np.random.default_rng(6)
        space = envs.single_action_space
        rec = {"spaces": [space_desc(envs.single_observation_space), space_desc(space)], "wrappers": wrappers,
               "reset": dig(obs), "steps": []}
        for i in range(40):
            if hasattr(space, "nvec"):  # MineDojo: an action type under the mask, arguments 0
                allowed = np.flatnonzero(obs["mask_action_type"][0][:16])
                action = np.array([[int(rng.choice(allowed)), 0, 0]])
            else:
                action = np.array([int(rng.integers(space.n))])
            obs, reward, terminated, truncated, info = envs.step(action)
            rec["steps"].append([dig(obs), np.asarray(reward, np.float64).tolist(), np.asarray(terminated).tolist(),
                                 np.asarray(truncated).tolist()])
        envs.close()
        out[name] = rec
    return out


# -- the port alone: the presets' dry runs and the MineDojo actor under the masks ----------------------------------
TINY = ["fabric.accelerator=cpu", "dry_run=True", "env.num_envs=1", "env.sync_env=True", "buffer.memmap=False",
        "metric.log_level=0", "algo.run_test=False"]
DV_TINY = ["algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
           "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.stochastic_size=4",
           "algo.world_model.discrete_size=4", "algo.per_rank_sequence_length=2", "algo.per_rank_batch_size=2",
           "algo.horizon=3"]
DV3_TINY = DV_TINY + ["algo.world_model.recurrent_model.dense_units=8", "env.screen_size=32"]
PRESET_RUNS = {
    "dreamer_v3_XL_crafter": DV3_TINY,
    "dreamer_v3_L_navigate": DV3_TINY,
    "dreamer_v3_minedojo": DV3_TINY,
    "dreamer_v3_super_mario_bros": DV3_TINY,
    # env.id=reward (the preset's) is refused by both packages' CrafterWrapper
    "dreamer_v2_crafter": DV_TINY + ["env.id=crafter_reward", "algo.per_rank_pretrain_steps=1"],
    "ppo_super_mario_bros": ["algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.dense_units=8",
                             "algo.encoder.cnn_features_dim=16", "env.screen_size=40"],
}


def preset_runs() -> Dict[str, Any]:
    import glob

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import load_config_file

    out = {}
    for exp, overrides in PRESET_RUNS.items():
        cli.run([f"exp={exp}", *TINY, *overrides, f"run_name={exp}"])
        (cfg_path,) = glob.glob(f"logs/runs/*/*/{exp}/version_0/config.yaml")
        cfg = load_config_file(cfg_path)
        out[exp] = {"target": cfg.env.wrapper["_target_"], "actor": cfg.select("algo.actor.cls"),
                    "ckpts": sorted(glob.glob(f"logs/runs/*/*/{exp}/version_0/checkpoint/*.ckpt"))}
    return out


def minedojo_actor_samples() -> Dict[str, Any]:
    """The port's MinedojoActor sampling under the masks of the preset's env:
    every sampled action is allowed by the masks it was sampled under, and
    the env takes it."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MinedojoActor, sample_actor_actions
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose("config", ["exp=dreamer_v3_minedojo", "env.capture_video=False", "env.screen_size=32"])
    env = make_env(cfg, 5, 0, 0)()
    nvec = [int(n) for n in env.action_space.nvec]
    actor = MinedojoActor(16, actions_dim=tuple(nvec), is_continuous=False, mlp_layers=1, dense_units=16, unimix=0.01)
    gen = torch.Generator().manual_seed(0)
    obs, _ = env.reset()
    bad, checked, types = [], 0, set()
    for _ in range(200):
        mask = {k: obs[k][None] for k in obs if k.startswith("mask_")}
        with torch.no_grad():
            pre = actor(torch.randn(1, 16, generator=gen))
        actions, _ = sample_actor_actions(actor, pre, generator=gen, mask=mask)
        a = [int(torch.argmax(x, -1)) for x in actions]
        types.add(a[0])
        legal = mask["mask_action_type"][0][a[0]]
        if a[0] == 15:
            legal &= mask["mask_craft_smelt"][0][a[1]]
        if a[0] in (16, 17):
            legal &= mask["mask_equip_place"][0][a[2]]
        if a[0] == 18:
            legal &= mask["mask_destroy"][0][a[2]]
        bad += [] if legal else [a]
        checked += 1
        obs, _, te, tr, _ = env.step(np.array(a))
        if te or tr:
            obs, _ = env.reset()
    return {"bad": bad, "checked": checked, "types": sorted(types)}


def main(pkg_name: str, out_path: str) -> None:
    pkg = {"jax": "sheeprl_tpu", "torch": "sheeprl_tpu_torch"}[pkg_name]
    results: Dict[str, Any] = {}
    for name, fn in (("crafter", crafter_checks), ("mario", mario_checks), ("diambra", diambra_checks),
                     ("minedojo", minedojo_checks), ("minerl", minerl_checks), ("pipeline", pipeline_checks)):
        results[name] = fn(pkg)
    if pkg_name == "torch":
        results["presets"] = preset_runs()
        results["minedojo_actor"] = minedojo_actor_samples()
        results["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "sheeprl_tpu"))
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
