"""Metric aggregation on the host (the port's own copy of ``MetricAggregator``
from ``sheeprl_tpu/utils/metric.py``, with the running mean, the one reducer
the DreamerV3 loop uses): name → mean with ``update``/``compute``/``reset``,
a class-level ``disabled`` switch, and NaN/inf left out on compute.
Aggregators are not thread-safe: under the overlap engine every update lands
on the learner thread (the player's episode stats ride its packets)."""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List

import numpy as np


class MetricAggregator:
    """A running mean for each name it was built with; other names are
    ignored."""

    disabled: bool = False

    def __init__(self, names: Iterable[str] = ()):
        self._sums: Dict[str, List[float]] = {name: [0.0, 0] for name in names}

    def update(self, name: str, value: Any) -> None:
        if MetricAggregator.disabled or name not in self._sums:
            return
        value = np.asarray(value, dtype=np.float64)
        acc = self._sums[name]
        acc[0] += float(np.sum(value))
        acc[1] += int(value.size)

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if MetricAggregator.disabled:
            return out
        for name, (total, count) in self._sums.items():
            if count and not (math.isnan(total) or math.isinf(total)):
                out[name] = total / count
        return out

    def reset(self) -> None:
        for acc in self._sums.values():
            acc[0], acc[1] = 0.0, 0
