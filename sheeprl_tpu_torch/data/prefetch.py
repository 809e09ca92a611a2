"""Staging the next replay batch while the card computes the current one (the
port's ``StagedPrefetcher``, counterpart of ``sheeprl_tpu/data/prefetch.py``).

``stage(g)`` samples the next ``[g, T, B, ...]`` batch now and starts its
host-to-device copy; ``take(g)`` returns it at the next train phase. The
training loop calls ``stage`` right after it has launched a burst, so the
sample and the copy overlap the burst's kernels.

On the card the batch is sampled into pinned host buffers and copied on a
CUDA stream of the prefetcher's own; an event after the copy is what the
consuming stream waits on in ``take`` (no host synchronisation). The
buffers come in two slots, each a pinned host batch and a device batch:

* a pinned batch is refilled only after its last copy has completed (the
  host waits for that copy's event, recorded one stage earlier);
* a device batch is overwritten only after the consumer is done with it:
  the consumer's stream records a "released" event for the batch it was
  handed, at its next ``stage`` or ``take`` (its work on that batch is
  launched by then), and the copy stream waits on that event first.

On the CPU ``stage`` keeps the sampled tensors and there is no stream.

Staging one iteration ahead means a staged batch cannot hold the very
latest transitions; at the warmup boundary the buffer may not serve a sample
yet (then nothing is staged), and a ``g`` other than the staged one samples
synchronously in ``take``, as the JAX package does.

Thread ownership: ``stage``/``take`` and the buffer they sample from are
the learner thread's alone; under the overlap engine the player hands its
transitions over a queue and the learner applies them before sampling.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..telemetry import device as device_counters

HostBatch = Dict[str, np.ndarray]


class _Slot:
    """A pinned host batch and a device batch of one shape, with the copy's
    event (``ready``) and the consumer's ``released`` event."""

    def __init__(self, host: HostBatch, device: torch.device):
        self.pinned = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype).pin_memory() for k, v in host.items()}
        self.views = {k: t.numpy() for k, t in self.pinned.items()}
        self.dev = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in self.pinned.items()}
        self.start: Optional[torch.cuda.Event] = None  # before the copy (timing)
        self.ready: Optional[torch.cuda.Event] = None
        self.released: Optional[torch.cuda.Event] = None
        self.nbytes = sum(t.numel() * t.element_size() for t in self.pinned.values())


class StagedPrefetcher:
    """``stage(g)``/``take(g)`` over ``sample_fn(g, out=None) -> host batch``
    (numpy arrays; with ``out``, the sample is written into those arrays
    and returned)."""

    def __init__(self, sample_fn: Callable[..., HostBatch], device: torch.device):
        self._sample = sample_fn
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._slots: Dict[int, List[_Slot]] = {}  # per g: two slots
        self._next: Dict[int, int] = {}  # per g: the slot the next fill takes
        self._lent: Optional[_Slot] = None  # the slot the consumer was last handed
        self._staged: Optional[tuple] = None  # (g, batch) on the CPU, (g, slot) on the card
        self._last: Optional[_Slot] = None  # the slot of the last copy
        self.copies = 0  # host-to-device batch copies started (staged or not)

    # -- the card ------------------------------------------------------------
    def _release_lent(self) -> None:
        """The consumer's stream marks the batch it was handed as released:
        everything it launched on it is queued by now."""
        if self._lent is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._lent.released = ev
            self._lent = None

    def _fill(self, g: int) -> _Slot:
        """Sample into a pinned slot and start its copy on the copy stream."""
        slots = self._slots.get(g)
        if slots is None:
            first = self._sample(g)  # the shapes of a [g, ...] batch
            slots = self._slots[g] = [_Slot(first, self.device), _Slot(first, self.device)]
            self._next[g] = 0
            slot = slots[0]
            for k, v in first.items():
                np.copyto(slot.views[k], v)
        else:
            slot = slots[self._next[g]]
            if slot.ready is not None:
                slot.ready.synchronize()  # its last copy out of the pinned batch is done
            self._sample(g, out=slot.views)
        self._next[g] = 1 - self._next[g]
        with torch.cuda.stream(self._stream):
            if slot.released is not None:
                self._stream.wait_event(slot.released)
            slot.start = torch.cuda.Event(enable_timing=True)
            slot.start.record(self._stream)
            for k, t in slot.pinned.items():
                slot.dev[k].copy_(t, non_blocking=True)
            slot.ready = torch.cuda.Event(enable_timing=True)
            slot.ready.record(self._stream)
        device_counters.record_h2d(*slot.pinned.values())
        self.copies += 1
        self._last = slot
        return slot

    def last_copy(self) -> Dict[str, float]:
        """Device ms and bytes of the last host-to-device batch copy (waits
        for it)."""
        slot = self._last
        slot.ready.synchronize()
        return {"ms": slot.start.elapsed_time(slot.ready), "bytes": slot.nbytes}

    def _lend(self, slot: _Slot) -> Dict[str, torch.Tensor]:
        torch.cuda.current_stream(self.device).wait_event(slot.ready)
        self._lent = slot
        return slot.dev

    # -- the contract ----------------------------------------------------------
    def _host(self, g: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v) for k, v in self._sample(g).items()}

    def stage(self, g: int) -> None:
        """Sample a [g, ...] batch and start its copy now; at the warmup
        boundary, where the buffer cannot serve it yet, stage nothing."""
        if self._cuda:
            self._release_lent()
        if g <= 0:
            self._staged = None
            return
        try:
            self._staged = (g, self._fill(g) if self._cuda else self._host(g))
        except ValueError:
            self._staged = None

    def take(self, g: int) -> Dict[str, torch.Tensor]:
        """The staged batch if it was staged for ``g``, else a synchronous
        sample."""
        staged, self._staged = self._staged, None
        if not self._cuda:
            return staged[1] if staged is not None and staged[0] == g else self._host(g)
        self._release_lent()
        slot = staged[1] if staged is not None and staged[0] == g else self._fill(g)
        return self._lend(slot)
