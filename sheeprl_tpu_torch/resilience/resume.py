"""The resume manifest and the ``resume`` command (counterpart of
``sheeprl_tpu/resilience/resume.py``).

Every successful checkpoint write refreshes ``<log_dir>/resume_manifest.json``:
the step, the checkpoint's path relative to the log dir, and the
fingerprint of the experiment-defining config subtree
(algo/env/buffer/distribution/seed, without the resume-protected
``algo.total_steps`` and ``algo.learning_starts``).

``python -m sheeprl_tpu_torch resume run_dir=<logs/runs/.../version_N>
[key=value ...] [force=true]`` reloads the run's saved config, applies the
overrides, refuses a config whose fingerprint no longer matches the
manifest's ("fingerprint mismatch", unless ``force=true``), wires the newest
complete checkpoint into ``checkpoint.resume_from`` and relaunches the
algorithm; a run dir without one raises ``FileNotFoundError`` ("no complete
checkpoint").
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

MANIFEST_NAME = "resume_manifest.json"
MANIFEST_SCHEMA = 1

# hardware (fabric), logging (metric), output naming and the
# checkpoint/resilience knobs are not part of the experiment's identity
_FINGERPRINT_GROUPS = ("algo", "env", "buffer", "distribution", "seed")
_FINGERPRINT_DROP_PATHS = (("algo", "total_steps"), ("algo", "learning_starts"))


def config_fingerprint(cfg: Any) -> str:
    """Stable hash of the experiment-defining config subtree."""
    as_dict = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
    picked: Dict[str, Any] = {k: as_dict.get(k) for k in _FINGERPRINT_GROUPS}
    for group, key in _FINGERPRINT_DROP_PATHS:
        node = picked.get(group)
        if isinstance(node, dict) and key in node:
            node = dict(node)
            node.pop(key, None)
            picked[group] = node
    canon = json.dumps(picked, sort_keys=True, default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def write_manifest(log_dir: str, cfg: Any, step: int, ckpt_path: str) -> str:
    """Atomically refresh ``<log_dir>/resume_manifest.json`` after a
    checkpoint write (the RunGuard wires this as the writer's ``on_write``)."""
    log_dir_p = Path(log_dir)
    try:
        rel = str(Path(ckpt_path).relative_to(log_dir_p))
    except ValueError:
        rel = str(ckpt_path)
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "fingerprint": config_fingerprint(cfg),
        "algo": cfg.select("algo.name"),
        "env_id": cfg.select("env.id"),
        "step": int(step),
        "checkpoint": rel,
        "updated_at": round(time.time(), 3),
    }
    path = log_dir_p / MANIFEST_NAME
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return str(path)


def read_manifest(log_dir: os.PathLike) -> Optional[Dict[str, Any]]:
    path = Path(log_dir) / MANIFEST_NAME
    if not path.is_file():
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def resolve_version_dir(run_dir: os.PathLike) -> Path:
    """A ``version_N`` log dir (it holds config.yaml), or the run's base dir
    above it (then its newest version that holds one)."""
    run_dir_p = Path(run_dir)
    if (run_dir_p / "config.yaml").is_file():
        return run_dir_p
    versions = sorted(
        (p for p in run_dir_p.glob("version_*") if (p / "config.yaml").is_file()),
        key=lambda p: int(p.name.split("_")[1]) if p.name.split("_")[1].isdigit() else -1,
    )
    if not versions:
        raise FileNotFoundError(f"Cannot resume: no saved config.yaml under {run_dir_p} "
                                "(expected a run log dir like logs/runs/<root>/<run>/version_0)")
    return versions[-1]


def find_latest_checkpoint(log_dir: Path, manifest: Optional[Dict[str, Any]] = None) -> Optional[Path]:
    """The newest complete checkpoint: the manifest's, else the highest step
    under ``<log_dir>/checkpoint/`` (``CheckpointManager.list_checkpoints``)."""
    if manifest and manifest.get("checkpoint"):
        cand = Path(log_dir) / str(manifest["checkpoint"])
        if cand.is_file():
            return cand
    from ..utils.checkpoint import CheckpointManager

    ckpts = CheckpointManager(str(log_dir), enabled=False).list_checkpoints()
    return ckpts[-1] if ckpts else None


def build_resume_config(run_dir: os.PathLike, overrides: Sequence[str] = (), force: bool = False) -> Tuple[Any, Path]:
    """The run's saved config with ``overrides`` applied and
    ``checkpoint.resume_from`` set to its newest checkpoint, after the
    fingerprint check. Returns ``(cfg, checkpoint path)``."""
    import yaml

    from ..config import load_config_file

    log_dir = resolve_version_dir(run_dir)
    cfg = load_config_file(log_dir / "config.yaml")
    manifest = read_manifest(log_dir)
    ckpt = find_latest_checkpoint(log_dir, manifest)
    if ckpt is None:
        raise FileNotFoundError(f"Cannot resume {log_dir}: no complete checkpoint found under "
                                f"{log_dir / 'checkpoint'} (the run may have died before its first save)")
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Malformed override '{ov}' (expected key=value)")
        k, _, v = ov.partition("=")
        cfg.set_path(k.strip(), yaml.safe_load(v))
    if manifest and manifest.get("fingerprint"):
        now = config_fingerprint(cfg)
        if now != manifest["fingerprint"] and not force:
            raise ValueError(
                f"Resume fingerprint mismatch for {log_dir}: the composed config hashes to {now} but the manifest "
                f"recorded {manifest['fingerprint']}. The experiment-defining config (algo/env/buffer/distribution/"
                "seed) changed since the checkpoint was written; pass force=true to resume all the same.")
    cfg.set_path("checkpoint.resume_from", str(ckpt))
    return cfg, ckpt


def resume_run(run_dir: os.PathLike, overrides: Sequence[str] = (), force: bool = False) -> None:
    """Relaunch a run from its newest checkpoint (the loop restores its
    parameters, optimizer states, generators and counters)."""
    from ..cli import check_configs, run_algorithm

    cfg, ckpt = build_resume_config(run_dir, overrides, force=force)
    check_configs(cfg)
    print(f"[resilience] resuming from {ckpt}", flush=True)
    run_algorithm(cfg)


def parse_resume_argv(argv: Sequence[str]) -> Tuple[str, List[str], bool]:
    """``run_dir=...`` and the optional ``force=...`` out of a resume argv."""
    import yaml

    run_dir: Optional[str] = None
    force = False
    rest: List[str] = []
    for a in argv:
        if a.startswith("run_dir="):
            run_dir = a.split("=", 1)[1]
        elif a.startswith("force="):
            force = bool(yaml.safe_load(a.split("=", 1)[1]))
        else:
            rest.append(a)
    if run_dir is None:
        raise ValueError("resume requires `run_dir=<logs/runs/.../version_N>`")
    return run_dir, rest, force
