"""The PyTorch port imports neither JAX (jax, flax, optax) nor anything of
the JAX package, and chip_smoke.py and the port's scripts
(scripts/torch_*.py, which run on the card too) import nothing of it: every
port module is imported in a fresh interpreter, a dry run of the dummy env
path runs there, and the loaded modules are checked; every import statement
of the port's sources is scanned.

The env suites' packages (gymnasium, dm_control and dm_env, cv2) are
imported by their adapters only, inside the functions that make an env or
transform an image: importing the port or running it on the dummy env loads
none of them (the card's machine has none)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sheeprl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")
SUITES = ("gymnasium", "dm_control", "dm_env", "cv2")
# the env adapters, and the suite packages each may import lazily
ADAPTERS = {
    PORT / "envs" / "gym_env.py": ("gymnasium",),
    PORT / "envs" / "dmc.py": ("dm_control", "dm_env"),
    PORT / "utils" / "env.py": ("cv2",),
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
        "print(json.dumps({'imported': mods, 'loaded': after_import, 'after_run': sorted(sys.modules)}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "sheeprl_tpu_torch.ops.ln_gru" in out["imported"]
    assert "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3" in out["imported"]
    for mod in ("engine.overlap", "parallel.placement", "resilience.guard", "resilience.ckpt_async",
                "resilience.preemption", "resilience.resume", "utils.checkpoint", "utils.metric", "utils.logger"):
        assert f"sheeprl_tpu_torch.{mod}" in out["imported"], mod
    leaked = [m for m in out["loaded"] if _forbidden(m, FORBIDDEN + SUITES)]
    assert not leaked, leaked
    leaked = [m for m in out["after_run"] if _forbidden(m, FORBIDDEN + SUITES)]
    assert not leaked, f"the dummy env path loaded {leaked}"


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
