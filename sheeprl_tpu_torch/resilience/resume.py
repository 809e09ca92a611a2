"""The resume manifest (the part of ``sheeprl_tpu/resilience/resume.py``
that the RunGuard calls; the ``resume`` command waits for a later slice).

Every successful checkpoint write refreshes ``<log_dir>/resume_manifest.json``:
the step, the checkpoint's path relative to the log dir, and the
fingerprint of the experiment-defining config subtree
(algo/env/buffer/distribution/seed, without the resume-protected
``algo.total_steps`` and ``algo.learning_starts``).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict

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
