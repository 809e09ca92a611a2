"""Command-line entry point of the PyTorch port:
``python -m sheeprl_tpu_torch run exp=dreamer_v3 env=dummy ...``,
``python -m sheeprl_tpu_torch eval checkpoint_path=<ckpt> [key=value ...]``,
``python -m sheeprl_tpu_torch resume run_dir=<logs/runs/.../version_N> [key=value ...] [force=true]``,
``python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt> [serve.http.port=... ...]``,
``gateway checkpoint_path=<ckpt> [gateway.replicas=... ...]``, ``brokerd [gateway.broker.*=...]``,
``flywheel run_dir=... checkpoint_path=<ckpt> [flywheel.*=...]``, the run
diagnostics ``doctor``, ``trace``, ``top`` and ``prof`` (``run_dir=...``), ``registration
checkpoint_path=<ckpt>`` and ``agents``.

``run`` composes the config from ``sheeprl_tpu_torch/configs``, merges the
saved config of ``checkpoint.resume_from`` when one is given, checks it
(``check_configs``), looks the algorithm up in the registry and calls its
``main(cfg)``; with ``resilience.supervisor.attempts > 1`` a crashed run is
restarted from its newest checkpoint (``resilience/supervisor.py``).
``eval`` rebuilds the run's config from the ``config.yaml`` beside the
checkpoint and calls the algorithm's registered evaluation on one env.
``resume`` relaunches a run from its newest checkpoint behind the manifest's
fingerprint check (``resilience/resume.py``). ``serve`` serves the
checkpoint behind the micro-batching policy server (``serve/server.py``)
on the run's player device; ``gateway`` behind N supervised replicas of it
(``gateway/cluster.py``, the replicas on the card by default), with
``brokerd`` the externalized session broker they can share
(``gateway/brokerd.py``); ``flywheel`` takes one turn of the data flywheel
over a serving run's capture (``flywheel/recipe.py``). ``doctor``, ``trace``, ``top`` and ``prof``
read what a run leaves behind (``diag/``, ``prof/``); ``registration``
splits a checkpoint into its algorithm's ``MODELS_TO_REGISTER`` groups in
the local model registry (``utils/model_manager.py``) or, with
``backend=mlflow``, on an MLflow server (``utils/mlflow_registry.py``).
"""
from __future__ import annotations

import functools
import importlib
import pathlib
import sys
from typing import Callable, List, Optional, Sequence, Tuple

from .config import CONFIG_ROOT, Config, compose, load_config_file
from .utils.registry import algorithm_registry, get_algorithm, get_evaluation

# modules whose import registers an algorithm and its evaluation
ALGORITHM_MODULES = (
    "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
    "sheeprl_tpu_torch.algos.ppo.ppo",
    "sheeprl_tpu_torch.algos.ppo.ppo_decoupled",
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


def resume_from_checkpoint(cfg: Config, overrides: Sequence[str] = ()) -> Config:
    """Merge the old run's saved config under the new one, keeping the keys
    a resume may change (``algo.total_steps``, ``algo.learning_starts``,
    ``root_dir``, ``run_name``, ``checkpoint.resume_from``) as given, and
    the ``fabric.*`` keys among the command line's ``overrides``: a
    resume may run on another mesh (DreamerV3 at another world size too)."""
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
    _apply_cli_overrides(merged, [ov for ov in overrides if ov.startswith("fabric.")])
    return merged


# the entry points that lay their parameters and optimizer states out over
# the mesh (maybe_shard_params / maybe_shard_opt_state), as the JAX package's do
SHARDED_ALGOS = ("dreamer_v3", "p2e_dv3_exploration", "p2e_dv3_finetuning")


def check_configs(cfg: Config) -> None:
    """The config checks before a run: an algorithm is selected and
    registered; the mesh (``parallel/mesh.py``) takes the config (a shape
    that does not multiply out, more devices than visible, raise); a
    decoupled algorithm has its player and its trainer: at
    ``fabric.devices >= 2``, as in the JAX package, or on one card with the
    player on the host (``algo.player.device=host``), where the JAX
    package's player would act anyway. DreamerV3 and the P2E-DV3 phases
    take any mesh, ZeRO-1 and more nodes; every other entry point runs on
    ``dp × fsdp`` as data parallelism with its parameters whole on every
    rank, as the JAX package runs it there, and refuses ``tp > 1`` and
    ``fabric.shard_optimizer_state`` (it lays out no parameter or optimizer
    state)."""
    _register()
    algo_name = cfg.select("algo.name")
    if algo_name is None:
        raise ValueError("Missing `algo.name`: select an experiment with `exp=<name>`")
    if algo_name not in algorithm_registry:
        raise ValueError(f"Algorithm '{algo_name}' is not registered. Available: {sorted(algorithm_registry)}")
    entry = algorithm_registry[algo_name]
    devices = int(cfg.select("fabric.devices", 1) or 1)
    if entry["decoupled"]:
        one_card = (devices == 1 and str(cfg.select("fabric.accelerator", "auto")).lower() != "cpu"
                    and cfg.select("algo.player.device") == "host")
        if devices < 2 and not one_card:
            raise RuntimeError(f"'{algo_name}' is a decoupled algorithm: it needs at least one player and one "
                               "trainer device (fabric.devices >= 2)")
    from .parallel.mesh import build_distributed

    dist = build_distributed(cfg)
    if algo_name not in SHARDED_ALGOS and (dist.tp > 1 or dist.shard_optimizer_state):
        what = f"fabric.mesh.tp={dist.tp}" if dist.tp > 1 else "fabric.shard_optimizer_state=True"
        raise NotImplementedError(f"{what}: '{algo_name}' lays out no parameter or optimizer state over the mesh "
                                  f"(the entry points that do: {', '.join(SHARDED_ALGOS)}); it runs on dp × fsdp "
                                  "ranks as data parallelism")


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
    from .parallel.mesh import launch

    entry = get_algorithm(cfg.algo.name)
    exploration = exploration_surgery(cfg).to_dict() if entry.get("requires_exploration_cfg") else None
    # one rank here, or fabric.devices spawned ranks (parallel/mesh.py)
    fn = functools.partial(launch, functools.partial(_run_registered, cfg.algo.name, exploration=exploration))
    attempts = int(cfg.select("resilience.supervisor.attempts", 1) or 1)
    if attempts > 1:
        from .resilience.supervisor import supervise

        supervise(fn, cfg, attempts=attempts, backoff_s=float(cfg.select("resilience.supervisor.backoff_s", 5.0)),
                  max_backoff_s=float(cfg.select("resilience.supervisor.max_backoff_s", 120.0)))
    else:
        fn(cfg)


def _run_registered(name: str, cfg: Config, exploration: Optional[dict] = None) -> None:
    """An algorithm's entry point on one rank (picklable for spawned
    ranks); a finetuning one gets the exploration run's config
    (``exploration``, as a dict)."""
    _register()
    from .utils.timer import timer

    # a class-level switch: set both ways, so a run never inherits it from an
    # earlier run in the same process
    timer.disabled = bool(cfg.select("metric.disable_timer", False))
    fn = get_algorithm(name)["fn"]
    if exploration is not None:
        fn = functools.partial(fn, exploration_cfg=Config(exploration))
    fn(cfg)


def run(args: Optional[Sequence[str]] = None) -> None:
    """``run [exp=... key=value ...]``: compose and train."""
    argv = list(args if args is not None else sys.argv[1:])
    cfg = compose("config", argv)
    if cfg.select("checkpoint.resume_from"):
        cfg = resume_from_checkpoint(cfg, argv)
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
    """One env, one device (whatever mesh and nodes the run had), the
    checkpoint's inference state."""
    _register()
    from .utils.checkpoint import CheckpointManager

    cfg.set_path("fabric.devices", 1)
    cfg.set_path("fabric.num_nodes", 1)
    for axis in ("dp", "fsdp", "tp"):
        cfg.set_path(f"fabric.mesh.{axis}", 1)
    cfg.set_path("fabric.strategy", "auto")
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


def serve(args: Optional[Sequence[str]] = None) -> None:
    """``serve checkpoint_path=... [serve.http.port=... ...]``: serve a
    trained checkpoint behind the micro-batching policy server
    (``serve/server.py``): bucketed apply on the card, deadline-coalesced
    batches, checkpoint hot reload and a stdlib-HTTP JSON endpoint."""
    argv = list(args if args is not None else sys.argv[1:])
    ckpt_path, rest = _split_checkpoint_arg(argv, "serve")
    cfg = _load_config_beside(ckpt_path)
    # a saved run config has no serve group: compose its defaults in
    if cfg.select("serve") is None:
        cfg["serve"] = load_config_file(CONFIG_ROOT / "serve" / "default.yaml")
    _apply_cli_overrides(cfg, rest)
    cfg["checkpoint_path"] = str(ckpt_path)
    from .serve.server import serve_from_checkpoint

    serve_from_checkpoint(ckpt_path, cfg)


def gateway(args: Optional[Sequence[str]] = None) -> None:
    """``gateway checkpoint_path=... [gateway.replicas=4 ...]``: serve a
    trained checkpoint behind the multi-replica gateway
    (``gateway/cluster.py``): N supervised PolicyServer replica processes
    (on ``cuda:0`` unless ``gateway.replica.platform=cpu``), sticky-session
    routing with broker-backed failover, admission control and rolling
    checkpoint hot reload."""
    argv = list(args if args is not None else sys.argv[1:])
    ckpt_path, rest = _split_checkpoint_arg(argv, "gateway")
    cfg = _load_config_beside(ckpt_path)
    # a saved run config has no serve/gateway groups: compose their defaults in
    for group in ("serve", "gateway"):
        if cfg.select(group) is None:
            cfg[group] = load_config_file(CONFIG_ROOT / group / "default.yaml")
    _apply_cli_overrides(cfg, rest)
    cfg["checkpoint_path"] = str(ckpt_path)
    from .gateway.cluster import gateway_from_checkpoint

    gateway_from_checkpoint(ckpt_path, cfg)


def brokerd(args: Optional[Sequence[str]] = None) -> None:
    """``brokerd [gateway.broker.listen_port=7070 gateway.broker.role=standby
    gateway.broker.peer=host:7070 ...]``: run one externalized session-broker
    daemon (``gateway/brokerd.py``), the WAL-durable, primary/standby
    replicated source of truth for sticky sessions that gateways running
    ``gateway.broker.mode=external`` speak to. Start the primary first, then
    the standby with ``role=standby peer=<primary host:port>``."""
    argv = list(args if args is not None else sys.argv[1:])
    cfg = Config({"gateway": load_config_file(CONFIG_ROOT / "gateway" / "default.yaml").to_dict()})
    _apply_cli_overrides(cfg, argv)
    from .gateway.brokerd import run_brokerd_from_cfg

    run_brokerd_from_cfg(cfg)


def flywheel_config(argv: Sequence[str]) -> Tuple[pathlib.Path, pathlib.Path, Config]:
    """``run_dir``, the checkpoint and the composed ``flywheel`` config of a
    ``flywheel`` command line."""
    run_dir: Optional[str] = None
    rest: List[str] = []
    for a in argv:
        if a.startswith("run_dir="):
            run_dir = a.split("=", 1)[1]
        else:
            rest.append(a)
    if run_dir is None:
        raise ValueError("flywheel requires `run_dir=<serving run dir>`")
    ckpt_path, rest = _split_checkpoint_arg(rest, "flywheel")
    cfg = Config({"flywheel": load_config_file(CONFIG_ROOT / "flywheel" / "default.yaml").to_dict()})
    _apply_cli_overrides(cfg, rest)
    return pathlib.Path(run_dir), ckpt_path, cfg


def flywheel(args: Optional[Sequence[str]] = None) -> None:
    """``flywheel run_dir=<serving run dir> checkpoint_path=<served ckpt>
    [flywheel.steps=100 ...]``: one turn of the data flywheel
    (``flywheel/recipe.py``): ingest the run's serve-side capture segments
    (exactly once, torn-tail tolerant, staleness-gated by
    ``flywheel.max_version_lag``), fine-tune ``flywheel.steps`` steps, write
    the result beside the served checkpoint and push it through the
    gateway's rolling reload (``flywheel.gateway_url``) or the replicas' own
    hot-reload polls."""
    run_dir, ckpt_path, cfg = flywheel_config(list(args if args is not None else sys.argv[1:]))
    from .flywheel.recipe import run_flywheel

    summary = run_flywheel(run_dir, ckpt_path, cfg=cfg)
    print(f"[flywheel] {summary}", flush=True)


def _diag_command(module: str) -> Callable[[Optional[Sequence[str]]], None]:
    """A diagnostics command: the module's ``main(argv)``, a non-zero return
    being the process's exit code."""

    def command(args: Optional[Sequence[str]] = None) -> None:
        rc = importlib.import_module(module).main(list(args if args is not None else sys.argv[1:]))
        if rc:
            raise SystemExit(rc)

    return command


# ``doctor run_dir=... [json=true] [strict=true]``: triage a slow or dead run
# from its telemetry stream, resume manifest and checkpoints (diag/doctor.py)
doctor = _diag_command("sheeprl_tpu_torch.diag.doctor")
# ``trace run_dir=... [trace_id=...] [top_k=10] [json=true]``: the run's
# per-process streams merged into cross-process critical paths (diag/trace.py)
trace = _diag_command("sheeprl_tpu_torch.diag.trace")
# ``top run_dir=... [refresh_s=2] [once=true] [json=true]``: watch a run
# live through its GET /live, or offline from its streams (diag/live.py)
top = _diag_command("sheeprl_tpu_torch.diag.live")
# ``prof run_dir=... [capture=<dir>] [top_k=15] [json=true]``: where the
# card's time went in the run's torch.profiler captures (prof/cli.py)
prof = _diag_command("sheeprl_tpu_torch.prof.cli")
# ``lint [paths...] [--json] [--rule r1,r2] [--list-rules]``: the static
# analysis pass over the port (default: the whole package; analysis/),
# exit 1 on an unsuppressed finding, 2 on a usage error or a rule the port
# does not have; suppress a line with ``# lint: ok[<rule>] <reason>``
lint = _diag_command("sheeprl_tpu_torch.analysis.engine")


def registration(args: Optional[Sequence[str]] = None) -> None:
    """``registration checkpoint_path=... [backend=local|mlflow]``: register
    a trained checkpoint, split per the algorithm's ``MODELS_TO_REGISTER``,
    in the local file registry (``utils/model_manager.py``, the default) or
    on an MLflow server (``backend=mlflow``: ``utils/mlflow_registry.py``,
    which needs the ``mlflow`` package and ``MLFLOW_TRACKING_URI``; it takes
    no other argument, since the models and their labels come from the
    run's config)."""
    argv = list(args if args is not None else sys.argv[1:])
    _register()
    from .utils.model_manager import register_models_from_checkpoint

    ckpt: Optional[str] = None
    backend = "local"
    rest: List[str] = []
    for a in argv:
        if a.startswith("checkpoint_path="):
            ckpt = a.split("=", 1)[1]
        elif a.startswith("backend="):
            backend = a.split("=", 1)[1]
        else:
            rest.append(a)
    if ckpt is None:
        raise ValueError("registration requires `checkpoint_path=<path to .ckpt>`")
    if backend == "mlflow":
        # the remote registry takes no per-model overrides: refusing the rest
        # beats the local backend using them and MLflow dropping them
        if rest:
            raise ValueError(
                f"backend=mlflow does not accept extra overrides, got {rest}; "
                "model selection/labels come from the experiment config "
                "(MODELS_TO_REGISTER) — drop the extra arguments or use backend=local"
            )
        from .utils.mlflow_registry import register_models_from_checkpoint_remote

        register_models_from_checkpoint_remote(pathlib.Path(ckpt))
    elif backend == "local":
        register_models_from_checkpoint(pathlib.Path(ckpt), rest)
    else:
        raise ValueError(f"Unknown registration backend '{backend}' (local | mlflow)")


def available_agents(args: Optional[Sequence[str]] = None) -> None:
    """``agents``: the registered algorithms, their entry points and whether
    they are decoupled."""
    _register()
    try:
        from rich.console import Console
        from rich.table import Table

        table = Table(title="SheepRL-TPU agents (PyTorch port)")
        table.add_column("Algorithm")
        table.add_column("Entrypoint")
        table.add_column("Decoupled")
        for name, info in sorted(algorithm_registry.items()):
            table.add_row(name, f"{info['module']}.{info['entrypoint']}", str(info["decoupled"]))
        Console().print(table)
    except ImportError:
        for name, info in sorted(algorithm_registry.items()):
            print(f"{name}: {info['module']}.{info['entrypoint']} decoupled={info['decoupled']}")


COMMANDS = {"run": run, "eval": evaluation, "resume": resume, "serve": serve, "doctor": doctor, "trace": trace,
            "top": top, "prof": prof, "registration": registration, "agents": available_agents,
            "gateway": gateway, "brokerd": brokerd, "flywheel": flywheel, "lint": lint}


def main() -> None:
    argv = sys.argv[1:]
    cmd, rest = (argv[0], argv[1:]) if argv and "=" not in argv[0] else ("run", argv)
    if cmd not in COMMANDS:
        raise SystemExit(f"unknown command {cmd!r}: the PyTorch port has {' | '.join(COMMANDS)}")
    COMMANDS[cmd](rest)
