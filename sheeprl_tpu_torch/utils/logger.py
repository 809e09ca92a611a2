"""Run directories and the TensorBoard logger (the port's own copy of
``sheeprl_tpu/utils/logger.py``).

``TensorBoardLogger`` writes scalars with ``torch.utils.tensorboard`` where
``tensorboard`` imports; where it does not, it says so once and writes them
to ``<log_dir>/metrics_fallback.jsonl`` as schema'd ``metrics`` events, as
the reference does, so no metric is dropped. ``metric.logger=mlflow`` raises:
MLflow is not installed here.
"""
from __future__ import annotations

import os
import sys
import types
import warnings
from pathlib import Path
from typing import Any, Dict, Optional


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


_tb_import_warned = False


def _scalars(metrics: Dict[str, Any]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, value in metrics.items():
        try:
            out[name] = float(value)
        except (TypeError, ValueError):
            continue
    return out


class TensorBoardLogger:
    """A ``SummaryWriter`` under the run's log dir, or the JSONL fallback
    stream where no writer imports; inert when ``enabled`` is False."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self.enabled = enabled
        self._writer = None
        self._fallback = None
        if not enabled:
            return
        # the writer needs tensorboard's event files only: tensorboard's
        # no-TensorFlow switch keeps it on its own stub instead of importing
        # TensorFlow, whose libraries crash MuJoCo's EGL renderer in one process
        sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
        except ImportError as err:
            global _tb_import_warned
            if not _tb_import_warned:
                _tb_import_warned = True
                warnings.warn(f"No TensorBoard SummaryWriter backend available ({err!r}); scalar metrics will be "
                              "written to the telemetry JSONL fallback stream instead", RuntimeWarning, stacklevel=2)

    @property
    def available(self) -> bool:
        """True when a SummaryWriter is attached."""
        return self._writer is not None

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not self.enabled:
            return
        clean = _scalars(metrics)
        if self._writer is not None:
            for name, value in clean.items():
                self._writer.add_scalar(name, value, global_step=step)
            return
        if clean:
            if self._fallback is None:
                from ..telemetry.sinks import JsonlSink

                self._fallback = JsonlSink(str(Path(self.log_dir) / "metrics_fallback.jsonl"))
            self._fallback.write({"event": "metrics", "step": int(step), "metrics": clean})

    def log_hyperparams(self, cfg: Dict[str, Any]) -> None:
        if self._writer is None:
            return
        import yaml

        self._writer.add_text("config", "```yaml\n" + yaml.safe_dump(cfg) + "\n```")

    def close(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None


def get_logger(cfg: Any, log_dir: str, process_index: int = 0) -> Optional[TensorBoardLogger]:
    """The rank-0 logger (None on other ranks or with ``metric.log_level=0``):
    ``metric.logger`` names the backend, ``tensorboard`` (the default) or
    ``mlflow``, which raises here."""
    if process_index != 0 or cfg.select("metric.log_level", 1) == 0:
        return None
    node = cfg.select("metric.logger", "tensorboard")
    kind = node if isinstance(node, str) else str(node.get("type", "tensorboard"))
    if kind == "mlflow":
        raise NotImplementedError("metric.logger=mlflow: MLflow is not installed, so the port has no MLflow logger")
    if kind != "tensorboard":
        raise ValueError(f"Unknown metric.logger '{kind}' (options: tensorboard, mlflow)")
    logger = TensorBoardLogger(log_dir)
    try:
        logger.log_hyperparams(cfg.to_dict())
    except Exception as err:  # noqa: BLE001 - the hyperparameters are best effort; metrics must flow
        print(f"[logger] log_hyperparams failed: {err}", file=sys.stderr)
    return logger
