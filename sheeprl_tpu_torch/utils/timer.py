"""The legacy wall-clock timer API (the port's own copy of
``sheeprl_tpu/utils/timer.py``), a shim over ``telemetry.spans``.

``with timer("Time/train_time"):`` adds its seconds to the process-wide
``SpanTracker`` that the ``Telemetry`` facade drains, and
``timer.compute()`` reads it (``reset=True`` drains it under its lock, so an
interval never counts time twice). The class-level ``disabled`` follows
``metric.disable_timer`` (set for each run by the CLI). New code uses
``Telemetry.span``; the shim keeps code that imports
``sheeprl_tpu_torch.utils.timer`` working.
"""
from __future__ import annotations

from contextlib import ContextDecorator
from typing import Dict, Optional

from ..telemetry.spans import GLOBAL_TRACKER, Span


class timer(ContextDecorator):
    disabled: bool = False

    def __init__(self, name: str):
        self.name = name
        self._span: Optional[Span] = None

    def __enter__(self) -> "timer":
        if not timer.disabled:
            self._span = Span(self.name, tracker=GLOBAL_TRACKER)
            self._span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._span is not None:
            self._span.__exit__(*exc)
            self._span = None
        return False

    @classmethod
    def to(cls, *_args, **_kwargs) -> None:
        """A no-op, as in the JAX package (the timers are host clocks)."""
        return None

    @classmethod
    def compute(cls, reset: bool = False) -> Dict[str, float]:
        """name -> seconds; ``reset=True`` drains."""
        return GLOBAL_TRACKER.compute(reset=reset)

    @classmethod
    def reset(cls) -> None:
        GLOBAL_TRACKER.reset()
