"""Run directories (the ``get_log_dir`` of ``sheeprl_tpu/utils/logger.py``;
the port writes no TensorBoard events: metrics print to stdout)."""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any


def get_log_dir(cfg: Any, root_dir: str, run_name: str, new_version: bool = True) -> str:
    """``logs/runs/<root_dir>/<run_name>/version_N`` under the working
    directory: a new N per run, or the latest with ``new_version=False``."""
    base = Path(os.getcwd()) / "logs" / "runs" / root_dir / run_name
    base.mkdir(parents=True, exist_ok=True)
    versions = sorted(
        int(p.name.split("_")[1])
        for p in base.iterdir()
        if p.is_dir() and p.name.startswith("version_") and p.name.split("_")[1].isdigit()
    )
    if versions and not new_version:
        version = versions[-1]
    else:
        version = (versions[-1] + 1) if versions else 0
    log_dir = base / f"version_{version}"
    log_dir.mkdir(parents=True, exist_ok=True)
    return str(log_dir)
