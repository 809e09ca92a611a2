"""Metric aggregation on the host (the port's own copy of ``RunningMetric``
and ``MetricAggregator`` from ``sheeprl_tpu/utils/metric.py``): name →
running reducer (``mean``, ``sum``, ``max``, ``min`` or ``last``) with
``update``/``compute``/``reset``, a class-level ``disabled`` switch, and
NaN/inf left out on compute. Aggregators are not thread-safe: under the
overlap engine every update lands on the learner thread (the player's
episode stats ride its packets)."""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping, Optional, Union

import numpy as np

KINDS = ("mean", "sum", "max", "min", "last")


class RunningMetric:
    """A running reducer. ``kind`` is one of ``KINDS``: ``mean`` over every
    element updated, ``sum`` of the updates' sums, ``max``/``min`` over every
    element, ``last`` the mean of the newest update."""

    def __init__(self, kind: str = "mean"):
        if kind not in KINDS:
            raise ValueError(f"metric kind must be one of {KINDS}, got {kind!r}")
        self.kind = kind
        self.reset()

    def reset(self) -> None:
        self._total = 0.0
        self._count = 0
        self._value: Optional[float] = None

    def update(self, value: Any) -> None:
        value = np.asarray(value, dtype=np.float64)
        if value.size == 0:
            return
        if self.kind in ("mean", "sum"):
            self._total += float(np.sum(value))
            self._count += int(value.size) if self.kind == "mean" else 1
        elif self.kind == "max":
            m = float(np.max(value))
            self._value = m if self._value is None else max(self._value, m)
        elif self.kind == "min":
            m = float(np.min(value))
            self._value = m if self._value is None else min(self._value, m)
        else:
            self._value = float(np.mean(value))

    def state(self) -> tuple:
        return (self._total, self._count, self._value)

    def combine(self, states: Iterable[tuple]) -> None:
        """Become the reducer of several reducers' ``state()`` of this kind
        (the ranks' intervals): means and sums add totals and counts,
        ``max``/``min`` take the extreme, ``last`` the mean of the newest."""
        states = list(states)
        self.reset()
        self._total = float(sum(s[0] for s in states))
        self._count = int(sum(s[1] for s in states))
        values = [s[2] for s in states if s[2] is not None]
        if values:
            self._value = {"max": max, "min": min}.get(self.kind, lambda v: float(np.mean(v)))(values)

    def compute(self) -> Optional[float]:
        if self.kind == "mean":
            return self._total / self._count if self._count else None
        if self.kind == "sum":
            return self._total if self._count else None
        return self._value


class MetricAggregator:
    """A running reducer for each name it was built with (a mapping name →
    kind, or names alone for means); other names are ignored."""

    disabled: bool = False

    def __init__(self, metrics: Union[Mapping[str, str], Iterable[str]] = ()):
        kinds = metrics if isinstance(metrics, Mapping) else {name: "mean" for name in metrics}
        self.metrics: Dict[str, RunningMetric] = {name: RunningMetric(kind) for name, kind in kinds.items()}

    def update(self, name: str, value: Any) -> None:
        if MetricAggregator.disabled or name not in self.metrics:
            return
        self.metrics[name].update(value)

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if MetricAggregator.disabled:
            return out
        for name, metric in self.metrics.items():
            v = metric.compute()
            if v is not None and not (math.isnan(v) or math.isinf(v)):
                out[name] = v
        return out

    def reset(self) -> None:
        for metric in self.metrics.values():
            metric.reset()

    def states(self) -> Dict[str, tuple]:
        return {name: metric.state() for name, metric in self.metrics.items()}

    def combine(self, states: Iterable[Mapping[str, tuple]]) -> None:
        """Become the aggregate of several aggregators' ``states()`` (this
        one's among them), name by name."""
        states = list(states)
        for name, metric in self.metrics.items():
            metric.combine([s[name] for s in states if name in s])
