"""The PyTorch port imports neither JAX (jax, flax, optax) nor anything of
the JAX package, and chip_smoke.py and the port's scripts
(scripts/torch_*.py, which run on the card too) import nothing of it: every
port module is imported in a fresh interpreter and the loaded modules are
checked, and every import statement of the port's sources is scanned."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sheeprl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu", "gymnasium")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import sheeprl_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, 'sheeprl_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps({'imported': mods, 'loaded': sorted(sys.modules)}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "sheeprl_tpu_torch.ops.ln_gru" in out["imported"]
    assert "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3" in out["imported"]
    for mod in ("engine.overlap", "parallel.placement", "resilience.guard", "resilience.ckpt_async",
                "resilience.preemption", "resilience.resume", "utils.checkpoint", "utils.metric", "utils.logger"):
        assert f"sheeprl_tpu_torch.{mod}" in out["imported"], mod
    leaked = [m for m in out["loaded"] if _forbidden(m)]
    assert not leaked, leaked


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
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
