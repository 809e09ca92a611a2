"""The PyTorch port imports neither JAX (jax, flax, optax) nor anything of
the JAX package, and chip_smoke.py and the port's scripts
(scripts/torch_*.py, which run on the card too) import nothing of it: every
port module is imported in a fresh interpreter, dry runs of the dummy env
path (DreamerV3, PPO on pixels with the watchdog on, SAC, SAC-AE, DreamerV2
on the episode buffer, DreamerV1 on a continuous action, P2E-DV3's
exploration→finetuning chain and P2E-DV2's exploration, at cut widths, and
a 2-worker SAC actor fleet, whose checkpoint is then served in process
through the serving stack, and a data-flywheel turn) run there, and the loaded modules are checked,
those of the fleet's spawned worker processes too (each worker's last
stream record names the top-level packages it loaded); every import statement of the
port's sources is scanned, and no config of the port names a class of the
JAX package.

The env suites' packages (gymnasium, dm_control and dm_env, cv2, crafter,
gym_super_mario_bros and nes_py, diambra, minedojo, minerl and the legacy
gym), mlflow and moviepy are imported by their adapters only, inside the
functions that make an env, a logger, a registry or a video, or transform
an image: importing the port or running it on the dummy env loads none of
them (the card's machine has none)."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sheeprl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")
SUITES = ("gymnasium", "dm_control", "dm_env", "cv2", "crafter", "gym_super_mario_bros", "nes_py", "diambra",
          "minedojo", "minerl", "gym", "mlflow", "moviepy")
# the env adapters, and the suite packages each may import lazily
ADAPTERS = {
    PORT / "envs" / "gym_env.py": ("gymnasium",),
    PORT / "envs" / "dmc.py": ("dm_control", "dm_env"),
    PORT / "utils" / "env.py": ("cv2",),
    PORT / "envs" / "crafter.py": ("crafter",),
    PORT / "envs" / "super_mario_bros.py": ("gym_super_mario_bros", "nes_py"),
    PORT / "envs" / "diambra.py": ("diambra",),
    PORT / "envs" / "minedojo.py": ("minedojo",),
    PORT / "envs" / "minerl.py": ("gym", "minerl"),
    PORT / "envs" / "minerl_envs" / "backend.py": ("minerl",),
    PORT / "envs" / "minerl_envs" / "navigate.py": ("minerl",),
    PORT / "envs" / "minerl_envs" / "obtain.py": ("minerl",),
    PORT / "envs" / "wrappers.py": ("moviepy",),
    PORT / "utils" / "logger.py": ("mlflow",),
    PORT / "utils" / "mlflow_registry.py": ("mlflow",),
}


def _forbidden(name: str, names=FORBIDDEN) -> bool:
    return any(name == f or name.startswith(f + ".") for f in names)


def test_importing_every_port_module_loads_no_jax(tmp_path):
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import sheeprl_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, 'sheeprl_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "after_import = sorted(sys.modules)\n"
        "from sheeprl_tpu_torch import cli\n"
        "cli.run(['exp=dreamer_v3', 'env=dummy', 'fabric.accelerator=cpu', 'dry_run=True', 'algo=dreamer_v3_XS',\n"
        "         'env.num_envs=2', 'algo.per_rank_sequence_length=2', 'algo.per_rank_batch_size=2',\n"
        "         'algo.dense_units=8', 'algo.world_model.recurrent_model.recurrent_state_size=8',\n"
        "         'algo.world_model.encoder.cnn_channels_multiplier=2', 'algo.run_test=False'])\n"
        "cli.run(['exp=ppo', 'env=dummy', 'fabric.accelerator=cpu', 'dry_run=True', 'env.num_envs=2',\n"
        "         'algo.rollout_steps=8', 'algo.per_rank_batch_size=8', 'algo.cnn_keys.encoder=[rgb]',\n"
        "         'resilience.watchdog.enabled=True'])\n"
        "cli.run(['exp=sac', 'env=dummy', 'env.id=continuous_dummy', 'fabric.accelerator=cpu', 'dry_run=True',\n"
        "         'env.num_envs=2', 'algo.hidden_size=16'])\n"
        "cli.run(['exp=sac_ae', 'env=dummy', 'env.id=continuous_dummy', 'fabric.accelerator=cpu', 'dry_run=True',\n"
        "         'env.num_envs=2', 'algo.cnn_channels_multiplier=1', 'algo.hidden_size=32',\n"
        "         'algo.per_rank_batch_size=8'])\n"
        "tiny = ['env=dummy', 'fabric.accelerator=cpu', 'dry_run=True', 'algo.dense_units=8', 'algo.mlp_layers=1',\n"
        "        'algo.world_model.encoder.cnn_channels_multiplier=2', 'algo.per_rank_sequence_length=2',\n"
        "        'algo.world_model.recurrent_model.recurrent_state_size=8', 'algo.per_rank_batch_size=2',\n"
        "        'algo.world_model.stochastic_size=4', 'algo.horizon=3', 'algo.run_test=False']\n"
        "cli.run(['exp=dreamer_v2', 'algo.world_model.discrete_size=4', 'buffer.type=episode', *tiny])\n"
        "cli.run(['exp=dreamer_v1', 'env.id=continuous_dummy', *tiny])\n"
        "v3 = ['env.num_envs=2', 'algo.world_model.discrete_size=4', 'algo.world_model.recurrent_model.dense_units=8',\n"
        "      'algo.cnn_keys.encoder=[rgb]', 'algo.ensembles.n=2', 'buffer.memmap=False']\n"
        "v3 += ['metric.log_level=0']\n"
        "cli.run(['exp=p2e_dv3_exploration', *tiny, *v3, 'algo.world_model.decoupled_rssm=True', 'run_name=ex'])\n"
        "import glob\n"
        "ckpt = sorted(glob.glob('logs/runs/p2e_dv3_exploration/*/ex/*/checkpoint/*.ckpt'))[-1]\n"
        "cli.run(['exp=p2e_dv3_finetuning', *tiny, *v3, f'checkpoint.exploration_ckpt_path={ckpt}'])\n"
        "cli.run(['exp=p2e_dv2_exploration', 'algo.world_model.discrete_size=4', 'algo.ensembles.n=2',\n"
        "         'algo.per_rank_pretrain_steps=1', 'metric.log_level=0', *tiny])\n"
        "cli.run(['exp=sac', 'env=dummy', 'env.id=continuous_dummy', 'fabric.accelerator=cpu', 'dry_run=True',\n"
        "         'env.num_envs=2', 'algo.hidden_size=16', 'algo.fleet.workers=2', 'run_name=fleet'])\n"
        "cli.run(['exp=ppo_decoupled', 'env=dummy', 'fabric.accelerator=cpu', 'fabric.devices=2', 'dry_run=True',\n"
        "         'env.num_envs=2', 'algo.rollout_steps=8', 'algo.per_rank_batch_size=4', 'algo.run_test=False',\n"
        "         'fabric.timeout_s=60'])\n"
        "from sheeprl_tpu_torch.config import load_config_file\n"
        "from sheeprl_tpu_torch.serve import serve_from_checkpoint\n"
        "sckpt = sorted(glob.glob('logs/runs/sac/*/fleet/version_0/checkpoint/*.ckpt'))[-1]\n"
        "scfg = load_config_file(sckpt.rsplit('/', 2)[0] + '/config.yaml')\n"
        "scfg['serve'] = load_config_file('%s/sheeprl_tpu_torch/configs/serve/default.yaml')\n"
        "scfg.set_path('serve.http.enabled', False)\n"
        "server = serve_from_checkpoint(sckpt, scfg, block=False)\n"
        "assert server.act({'state': [0.0] * 10}, deterministic=True).shape == (1, 2)\n"
        "server.stop()\n"
        "import numpy as np\n"
        "from sheeprl_tpu_torch.flywheel import CaptureWriter, run_flywheel, write_checkpoint\n"
        "cw = CaptureWriter('fw/capture/replica_000/capture.jsonl')\n"
        "for i in range(4): cw.record('s', {'x': [[1.0]]}, [[2.0]], 0, trace_id=f't{i}')\n"
        "cw.close()\n"
        "seed = write_checkpoint('fw/checkpoint', 0, {'params': {'w': np.zeros((1,), np.float32)}})\n"
        "assert run_flywheel('fw', seed, cfg=scfg.__class__({'flywheel': {'algo': 'synthetic_counter',\n"
        "                    'steps': 2, 'batch_size': 2}}))['checkpoint'].endswith('ckpt_2.ckpt')\n"
        "workers = [[json.loads(l) for l in open(p)][-2:] for p in\n"
        "           sorted(glob.glob('logs/runs/sac/*/fleet/version_0/workers/*/telemetry.jsonl'))]\n"
        "print(json.dumps({'imported': mods, 'loaded': after_import, 'after_run': sorted(sys.modules),\n"
        "                  'workers': workers}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    code = code.replace("%s", str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "sheeprl_tpu_torch.ops.ln_gru" in out["imported"]
    assert "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3" in out["imported"]
    for mod in ("engine.overlap", "parallel.placement", "resilience.guard", "resilience.ckpt_async",
                "resilience.preemption", "resilience.resume", "resilience.supervisor", "algos.ppo.agent",
                "algos.ppo.loss", "algos.ppo.utils", "algos.ppo.ppo", "algos.a2c.agent", "algos.a2c.loss",
                "algos.a2c.a2c", "algos.ppo_recurrent.agent", "algos.ppo_recurrent.utils",
                "algos.ppo_recurrent.ppo_recurrent", "algos.sac.agent", "algos.sac.loss", "algos.sac.utils",
                "algos.sac.sac", "algos.sac.sac_decoupled", "algos.droq.agent", "algos.droq.droq",
                "algos.sac_ae.agent", "algos.sac_ae.utils", "algos.sac_ae.sac_ae", "algos.dreamer_v2.agent",
                "algos.dreamer_v2.loss", "algos.dreamer_v2.utils", "algos.dreamer_v2.dreamer_v2",
                "algos.dreamer_v1.agent", "algos.dreamer_v1.loss", "algos.dreamer_v1.utils",
                "algos.dreamer_v1.dreamer_v1", "algos.p2e_dv3.agent", "algos.p2e_dv3.p2e_dv3_exploration",
                "algos.p2e_dv3.p2e_dv3_finetuning", "algos.p2e_dv2.agent", "algos.p2e_dv2.p2e_dv2_exploration",
                "algos.p2e_dv2.p2e_dv2_finetuning", "algos.p2e_dv1.agent", "algos.p2e_dv1.p2e_dv1_exploration",
                "algos.p2e_dv1.p2e_dv1_finetuning", "models.ensembles", "data.device_ring", "optim",
                "utils.checkpoint", "utils.metric", "utils.logger",
                "telemetry.schema", "telemetry.sinks", "telemetry.spans", "telemetry.memory", "telemetry.throughput",
                "telemetry.device", "telemetry.facade", "telemetry.tracing", "telemetry.relay", "resilience.chaos",
                "fleet.protocol", "fleet.net", "fleet.supervisor", "fleet.worker", "fleet.act_core",
                "fleet.programs", "fleet.engine", "fleet.remote", "fleet.act_service", "fleet.anakin",
                "serve.policy", "serve.builders", "serve.batcher", "serve.reload", "serve.server", "serve.evaluate",
                "serve.session_codec", "diag.prometheus", "diag.timeline", "diag.findings", "diag.trace",
                "diag.doctor", "diag.aggregator", "diag.live", "prof.capture", "prof.cli", "utils.model_manager",
                "parallel.mesh", "algos.ppo.ppo_decoupled", "gateway.admission", "gateway.broker", "gateway.wal",
                "gateway.replica", "gateway.gateway", "gateway.cluster", "gateway.brokerd", "gateway.broker_client",
                "flywheel.capture", "flywheel.ingest", "flywheel.recipe", "utils.imports", "utils.timer",
                "utils.mlflow_registry", "envs.legacy", "envs.crafter", "envs.super_mario_bros", "envs.diambra",
                "envs.minedojo", "envs.minerl", "envs.minerl_envs", "envs.minerl_envs.backend",
                "envs.minerl_envs.navigate", "envs.minerl_envs.obtain"):
        assert f"sheeprl_tpu_torch.{mod}" in out["imported"], mod
    leaked = [m for m in out["loaded"] if _forbidden(m, FORBIDDEN + SUITES)]
    assert not leaked, leaked
    leaked = [m for m in out["after_run"] if _forbidden(m, FORBIDDEN + SUITES)]
    assert not leaked, f"the dummy env path loaded {leaked}"
    # each spawned fleet worker's last records: its exit record (the
    # packages it loaded, whether it initialised CUDA) before the relay's
    assert len(out["workers"]) == 2
    for records in out["workers"]:
        exit_rec = next(r for r in records if r.get("action") == "worker_exit")
        assert "torch" in exit_rec["packages"] and not exit_rec["cuda_initialized"]
        leaked = [m for m in exit_rec["packages"] if _forbidden(m, FORBIDDEN + SUITES)]
        assert not leaked, f"a fleet worker loaded {leaked}"


def _imports(path: Path, top_level: bool = False):
    """The modules ``path`` imports (with ``top_level``, only the imports
    outside any function body)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = ast.walk(tree)
    if top_level:
        def outside(node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return
            yield node
            for child in ast.iter_child_nodes(node):
                yield from outside(child)

        nodes = outside(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(files) > 30
    assert PORT / "engine" / "overlap.py" in files and PORT / "resilience" / "guard.py" in files
    assert PORT / "telemetry" / "facade.py" in files and PORT / "telemetry" / "schema.py" in files
    assert PORT / "serve" / "server.py" in files and PORT / "diag" / "prometheus.py" in files
    assert PORT / "diag" / "doctor.py" in files and PORT / "prof" / "capture.py" in files
    assert PORT / "utils" / "model_manager.py" in files
    assert PORT / "gateway" / "brokerd.py" in files and PORT / "flywheel" / "recipe.py" in files
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imports(f) if _forbidden(name)]
    assert not bad, bad


def test_env_suites_are_imported_by_their_adapters_only_and_lazily():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + sorted((REPO / "scripts").glob("torch_*.py"))
    for f in files:
        allowed = ADAPTERS.get(f, ())
        bad = [n for n in _imports(f) if _forbidden(n, SUITES) and not _forbidden(n, allowed)]
        assert not bad, (str(f.relative_to(REPO)), bad)
        eager = [n for n in _imports(f, top_level=True) if _forbidden(n, SUITES)]
        assert not eager, (str(f.relative_to(REPO)), eager)
    for f, names in ADAPTERS.items():
        assert any(_forbidden(n, names) for n in _imports(f)), f


def test_no_port_config_names_a_class_of_the_jax_package():
    """Every dotted path in the port's YAML configs (``_target_``,
    ``actor.cls``, ...) names the port, never ``sheeprl_tpu.``: the P2E
    presets' ``actor.cls`` entries are the first that could."""
    import re

    configs = sorted((PORT / "configs").rglob("*.yaml"))
    assert len(configs) > 40 and PORT / "configs" / "algo" / "p2e_dv2.yaml" in configs
    bad = [(str(f.relative_to(REPO)), m) for f in configs
           for m in re.findall(r"\bsheeprl_tpu\.[\w.]+", f.read_text())]
    assert not bad, bad
    named = [m for f in configs for m in re.findall(r"\bsheeprl_tpu_torch\.[\w.]+", f.read_text())]
    assert "sheeprl_tpu_torch.algos.p2e_dv2.agent.Actor" in named and "sheeprl_tpu_torch.algos.p2e_dv1.agent.Actor" in named
