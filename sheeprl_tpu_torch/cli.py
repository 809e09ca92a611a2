"""Command-line entry point of the PyTorch port:
``python -m sheeprl_tpu_torch run exp=dreamer_v3 env=dummy ...``,
``python -m sheeprl_tpu_torch eval checkpoint_path=<ckpt> [key=value ...]`` and
``python -m sheeprl_tpu_torch resume run_dir=<logs/runs/.../version_N> [key=value ...] [force=true]``.

``run`` composes the config from ``sheeprl_tpu_torch/configs``, merges the
saved config of ``checkpoint.resume_from`` when one is given, checks it
(``check_configs``), looks the algorithm up in the registry and calls its
``main(cfg)``; with ``resilience.supervisor.attempts > 1`` a crashed run is
restarted from its newest checkpoint (``resilience/supervisor.py``).
``eval`` rebuilds the run's config from the ``config.yaml`` beside the
checkpoint and calls the algorithm's registered evaluation on one env.
``resume`` relaunches a run from its newest checkpoint behind the manifest's
fingerprint check (``resilience/resume.py``). The serving commands wait for
later slices.
"""
from __future__ import annotations

import functools
import importlib
import pathlib
import sys
from typing import List, Optional, Sequence, Tuple

from .config import Config, compose, load_config_file
from .utils.registry import algorithm_registry, get_algorithm, get_evaluation

# modules whose import registers an algorithm and its evaluation
ALGORITHM_MODULES = (
    "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
    "sheeprl_tpu_torch.algos.ppo.ppo",
    "sheeprl_tpu_torch.algos.a2c.a2c",
    "sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent",
    "sheeprl_tpu_torch.algos.sac.sac",
    "sheeprl_tpu_torch.algos.sac.sac_decoupled",
    "sheeprl_tpu_torch.algos.droq.droq",
    "sheeprl_tpu_torch.algos.sac_ae.sac_ae",
    "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2",
    "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning",
)
# the env settings a finetuning run takes from its exploration run
EXPLORATION_ENV_KEYS = ("frame_stack", "screen_size", "action_repeat", "grayscale", "clip_rewards",
                        "frame_stack_dilation", "max_episode_steps", "reward_as_observation")


def _register() -> None:
    for mod in ALGORITHM_MODULES:
        importlib.import_module(mod)


def resume_from_checkpoint(cfg: Config) -> Config:
    """Merge the old run's saved config under the new one, keeping the keys
    a resume may change (``algo.total_steps``, ``algo.learning_starts``,
    ``root_dir``, ``run_name``, ``checkpoint.resume_from``) as given."""
    ckpt_path = pathlib.Path(cfg.checkpoint.resume_from)
    old_cfg_path = ckpt_path.parent.parent / "config.yaml"
    if not old_cfg_path.is_file():
        raise FileNotFoundError(f"Cannot resume from {ckpt_path}: missing saved config at {old_cfg_path}")
    old_cfg = load_config_file(old_cfg_path)
    if old_cfg.select("env.id") != cfg.select("env.id"):
        raise ValueError(
            f"Cannot resume: checkpoint was trained on env '{old_cfg.select('env.id')}' "
            f"but the current config selects '{cfg.select('env.id')}'"
        )
    if old_cfg.select("algo.name") != cfg.select("algo.name"):
        raise ValueError(
            f"Cannot resume: checkpoint algorithm is '{old_cfg.select('algo.name')}' "
            f"but the current config selects '{cfg.select('algo.name')}'"
        )
    protected = {
        "algo.total_steps": cfg.select("algo.total_steps"),
        "algo.learning_starts": cfg.select("algo.learning_starts"),
        "root_dir": cfg.select("root_dir"),
        "run_name": cfg.select("run_name"),
        "checkpoint.resume_from": cfg.select("checkpoint.resume_from"),
    }
    merged = Config(cfg.to_dict())
    merged.merge(old_cfg)
    for path, value in protected.items():
        if value is not None:
            merged.set_path(path, value)
    return merged


def check_configs(cfg: Config) -> None:
    """The config checks before a run: an algorithm is selected and
    registered, and a decoupled one has the two devices it needs."""
    _register()
    algo_name = cfg.select("algo.name")
    if algo_name is None:
        raise ValueError("Missing `algo.name`: select an experiment with `exp=<name>`")
    if algo_name not in algorithm_registry:
        raise ValueError(f"Algorithm '{algo_name}' is not registered. Available: {sorted(algorithm_registry)}")
    if algorithm_registry[algo_name]["decoupled"] and int(cfg.select("fabric.devices", 1) or 1) < 2:
        raise RuntimeError(f"'{algo_name}' is a decoupled algorithm: it needs at least one player and one trainer "
                           "device (fabric.devices >= 2)")


def exploration_surgery(cfg: Config) -> Config:
    """The exploration→finetuning surgery: load the ``config.yaml`` two
    levels above ``checkpoint.exploration_ckpt_path`` (the exploration
    run's log dir), refuse a different ``env.id``, copy the exploration
    run's ``env`` settings (``EXPLORATION_ENV_KEYS``) into ``cfg`` and
    return the exploration config (the entry point inherits its ``algo``
    settings)."""
    path = cfg.select("checkpoint.exploration_ckpt_path")
    if not path or path == "???":
        raise ValueError(f"{cfg.algo.name} finetunes an exploration run: set "
                         "checkpoint.exploration_ckpt_path=<its ckpt_<step>.ckpt>")
    cfg_path = pathlib.Path(path).parent.parent / "config.yaml"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"Missing the exploration run's saved config at {cfg_path}")
    exploration_cfg = load_config_file(cfg_path)
    if exploration_cfg.select("env.id") != cfg.select("env.id"):
        raise ValueError(
            "This experiment is run with a different environment from the one of the exploration you want to "
            f"finetune. Got '{cfg.select('env.id')}', but the exploration used {exploration_cfg.select('env.id')}.")
    for k in EXPLORATION_ENV_KEYS:
        if exploration_cfg.select(f"env.{k}") is not None:
            cfg.set_path(f"env.{k}", exploration_cfg.select(f"env.{k}"))
    return exploration_cfg


def run_algorithm(cfg: Config) -> None:
    """The algorithm's entry point; with ``resilience.supervisor.attempts >
    1``, under ``supervise`` (a crash restarts from the newest checkpoint).
    A finetuning entry point (``requires_exploration_cfg``) gets the
    exploration run's config (``exploration_surgery``), also when the run
    is resumed or restarted."""
    check_configs(cfg)
    entry = get_algorithm(cfg.algo.name)
    fn = entry["fn"]
    if entry.get("requires_exploration_cfg"):
        fn = functools.partial(fn, exploration_cfg=exploration_surgery(cfg))
    attempts = int(cfg.select("resilience.supervisor.attempts", 1) or 1)
    if attempts > 1:
        from .resilience.supervisor import supervise

        supervise(fn, cfg, attempts=attempts, backoff_s=float(cfg.select("resilience.supervisor.backoff_s", 5.0)),
                  max_backoff_s=float(cfg.select("resilience.supervisor.max_backoff_s", 120.0)))
    else:
        fn(cfg)


def run(args: Optional[Sequence[str]] = None) -> None:
    """``run [exp=... key=value ...]``: compose and train."""
    argv = list(args if args is not None else sys.argv[1:])
    cfg = compose("config", argv)
    if cfg.select("checkpoint.resume_from"):
        cfg = resume_from_checkpoint(cfg)
    check_configs(cfg)
    run_algorithm(cfg)


def _split_checkpoint_arg(argv: Sequence[str], command: str) -> Tuple[pathlib.Path, List[str]]:
    """Pull ``checkpoint_path=...`` out of an argv, checking it exists."""
    ckpt: Optional[str] = None
    rest: List[str] = []
    for a in argv:
        if a.startswith("checkpoint_path="):
            ckpt = a.split("=", 1)[1]
        else:
            rest.append(a)
    if ckpt is None:
        raise ValueError(f"{command} requires `checkpoint_path=<path to .ckpt>`")
    ckpt_path = pathlib.Path(ckpt)
    if not ckpt_path.is_file():
        raise FileNotFoundError(f"Checkpoint not found: {ckpt_path}")
    return ckpt_path, rest


def _load_config_beside(ckpt_path: pathlib.Path) -> Config:
    cfg_path = ckpt_path.parent.parent / "config.yaml"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"Missing saved config beside checkpoint: {cfg_path}")
    return load_config_file(cfg_path)


def _apply_cli_overrides(cfg: Config, overrides: Sequence[str]) -> None:
    """Apply ``a.b.c=value`` overrides to a loaded config; a malformed
    override (no '=') is an error."""
    import yaml

    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Malformed override '{ov}' (expected key=value)")
        k, _, v = ov.partition("=")
        cfg.set_path(k.strip(), yaml.safe_load(v))


def eval_algorithm(cfg: Config) -> None:
    """One env, one device, the checkpoint's inference state."""
    _register()
    from .utils.checkpoint import CheckpointManager

    cfg.set_path("fabric.devices", 1)
    cfg.set_path("env.num_envs", 1)
    entry = get_evaluation(cfg.algo.name)
    state = CheckpointManager.load_for_inference(cfg.checkpoint_path)
    entry["fn"](cfg, state)


def evaluation(args: Optional[Sequence[str]] = None) -> None:
    """``eval checkpoint_path=... [key=value ...]``: rebuild the run config
    from the checkpoint's saved config.yaml and evaluate."""
    argv = list(args if args is not None else sys.argv[1:])
    ckpt_path, rest = _split_checkpoint_arg(argv, "evaluation")
    cfg = _load_config_beside(ckpt_path)
    _apply_cli_overrides(cfg, rest)
    cfg["checkpoint_path"] = str(ckpt_path)
    eval_algorithm(cfg)


def resume(args: Optional[Sequence[str]] = None) -> None:
    """``resume run_dir=<logs/runs/.../version_N> [key=value ...] [force=true]``:
    continue a preempted or crashed run from its newest complete checkpoint."""
    from .resilience.resume import parse_resume_argv, resume_run

    argv = list(args if args is not None else sys.argv[1:])
    run_dir, rest, force = parse_resume_argv(argv)
    resume_run(run_dir, rest, force=force)


COMMANDS = {"run": run, "eval": evaluation, "resume": resume}


def main() -> None:
    argv = sys.argv[1:]
    cmd, rest = (argv[0], argv[1:]) if argv and "=" not in argv[0] else ("run", argv)
    if cmd not in COMMANDS:
        raise SystemExit(f"unknown command {cmd!r}: the PyTorch port has {' | '.join(COMMANDS)}")
    COMMANDS[cmd](rest)
