"""Actor/learner placement (counterpart of ``sheeprl_tpu/parallel/placement.py``).

The learner's train step updates the world model and the actor in place, so
a player that acted with the learner's own modules would read weights in the
middle of an optimizer step. The player acts with a :class:`ParamMirror`
instead: its own copy of ``wm`` and ``actor``, refreshed by the learner after
every burst.

``algo.player.device`` says where that copy lives and where the player acts:

* ``auto`` (default): the learner's device. The JAX package's ``auto`` puts
  the player on the host CPU whenever the backend is an accelerator, a choice
  made for a TPU reached over a network link; a card on the local PCIe bus
  has no such link, so the port keeps the player beside the learner;
* ``host``: the CPU; the refresh is a device-to-host copy into pinned memory;
* ``accelerator``: the CUDA device; raises when there is none.

Nothing resolves to the CPU because a card is missing.
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def player_device(cfg: Any, learner: torch.device) -> torch.device:
    """Resolve ``algo.player.device`` against the learner's device."""
    mode = (cfg.select("algo.player.device", "auto") if cfg is not None else None) or "auto"
    if mode == "auto":
        return learner
    if mode == "host":
        return torch.device("cpu")
    if mode == "accelerator":
        if learner.type == "cuda":
            return learner
        if not torch.cuda.is_available():
            raise RuntimeError("algo.player.device=accelerator needs a CUDA device and none is available")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"algo.player.device must be auto | host | accelerator, got {mode!r}")


def _tensors(modules: Dict[str, torch.nn.Module]) -> List[torch.Tensor]:
    return [t for name in sorted(modules) for t in (*modules[name].parameters(), *modules[name].buffers())]


class ParamMirror:
    """The player's copy of (``wm``, ``actor``), double-buffered.

    ``refresh(modules)`` (learner thread) copies the learner's tensors into
    the slot the player is not reading, in the learner's stream order, so
    after the burst's kernels, and records a CUDA event after the copy.
    ``current()`` (player thread) returns the modules to act with:

    * blocking refresh (default): the newest slot at once; on the card the
      player's stream waits on the copy's event (``wait_event``, no host
      sync); on the host the thread waits for that event alone;
    * ``async_refresh``: the newest slot only once its event has completed
      (``event.query()``), else the previous one.

    A slot the player still reads is never overwritten: the learner writes
    only the other slot, and when the player swaps away from a slot on the
    card it records a "released" event on its stream, which the learner's
    stream waits on before it writes that slot again. The pending-slot
    handoff takes a small lock, once per env step and once per burst.
    """

    def __init__(self, modules: Dict[str, torch.nn.Module], device: torch.device, async_refresh: bool = False):
        self.device = torch.device(device)
        self.async_refresh = bool(async_refresh)
        src = _tensors(modules)
        pin = self.device.type == "cpu" and bool(src) and src[0].is_cuda
        self._slots = [self._clone(modules, pin) for _ in range(2)]
        self._dst = [_tensors(s) for s in self._slots]
        if any(t.is_cuda for t in self._dst[0][:1] + src[:1]):
            # once, at set-up: the clones' copies have landed before another
            # stream (the player's) reads them
            torch.cuda.current_stream(self._dst[0][0].device if self._dst[0][0].is_cuda else src[0].device).synchronize()
        self._cur = 0
        self._pending: Optional[int] = None
        self._ready: List[Any] = [None, None]  # event after the copy into each slot
        self._released: List[Any] = [None, None]  # player-stream event at its swap away from each slot
        self._lock = threading.Lock()
        self.refreshes = 0
        self._refresh_host_s = 0.0  # learner time spent in refresh()
        self._player_wait_s = 0.0  # host-player time spent waiting for a copy
        self._copies: List[Any] = []  # (start, end) timing events of copies on the card not yet read
        self._copy_ms, self._copies_read = 0.0, 0

    def _clone(self, modules: Dict[str, torch.nn.Module], pin: bool) -> Dict[str, torch.nn.Module]:
        out = {}
        for name, m in modules.items():
            c = copy.deepcopy(m).to(self.device)
            c.requires_grad_(False)
            if pin:  # pinned host memory: the device-to-host refresh runs asynchronously
                for t in (*c.parameters(), *c.buffers()):
                    t.data = t.data.pin_memory()
            out[name] = c
        return out

    def refresh(self, modules: Dict[str, torch.nn.Module]) -> None:
        t0 = time.perf_counter()
        src = _tensors(modules)
        with self._lock:
            w = 1 - self._cur
            self._pending = None  # the player may not swap to w while it is written
        dst = self._dst[w]
        cuda_dev = src[0].device if src[0].is_cuda else (self.device if self.device.type == "cuda" else None)
        stream = torch.cuda.current_stream(cuda_dev) if cuda_dev is not None else None
        if stream is not None and self._released[w] is not None:
            stream.wait_event(self._released[w])
        if stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        with torch.no_grad():
            if src[0].device == dst[0].device:
                torch._foreach_copy_(dst, src)
            else:
                for d, s in zip(dst, src):
                    d.copy_(s, non_blocking=True)
        if stream is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            self._ready[w] = ev
            self._copies.append((start, ev))
        with self._lock:
            self._pending = w
        self.refreshes += 1
        self._refresh_host_s += time.perf_counter() - t0

    def current(self) -> Dict[str, torch.nn.Module]:
        with self._lock:
            w = self._pending
            if w is not None:
                ev = self._ready[w]
                if ev is not None and self.async_refresh and not ev.query():
                    return self._slots[self._cur]
                if self.device.type == "cuda":
                    stream = torch.cuda.current_stream(self.device)
                    if ev is not None:
                        stream.wait_event(ev)
                    released = torch.cuda.Event()
                    released.record(stream)
                    self._released[self._cur] = released
                elif ev is not None:
                    t0 = time.perf_counter()
                    ev.synchronize()  # the device-to-host copy into pinned memory
                    self._player_wait_s += time.perf_counter() - t0
                self._cur, self._pending = w, None
            return self._slots[self._cur]


    def stats(self) -> Dict[str, Any]:
        """Refreshes so far, the learner's host time in ``refresh`` (ms per
        refresh), the copies' device time where they ran on the card (ms per
        copy, over the copies that have completed) and the host player's
        total wait for its copies (ms). Reading it syncs nothing."""
        waiting = []
        for a, b in self._copies:
            if b.query():
                self._copy_ms += a.elapsed_time(b)
                self._copies_read += 1
            else:
                waiting.append((a, b))
        self._copies = waiting
        n = self.refreshes
        return {
            "refreshes": n,
            "refresh_host_ms": self._refresh_host_s * 1e3 / n if n else None,
            "copy_ms": self._copy_ms / self._copies_read if self._copies_read else None,
            "player_wait_ms": self._player_wait_s * 1e3,
            "device": str(self.device),
            "async_refresh": self.async_refresh,
        }


def make_param_mirror(cfg: Any, learner: torch.device, modules: Dict[str, torch.nn.Module], seed: int):
    """The player's setup in one place: its device, the mirror of its
    modules there, and its own random generator (``torch.Generator`` is not
    thread-safe, so the player never shares the train step's), seeded from
    the run's seed. Returns ``(mirror, device, generator)``."""
    pdev = player_device(cfg, learner)
    mirror = ParamMirror(modules, pdev, async_refresh=bool(cfg.select("algo.player.async_refresh", False)))
    gen = torch.Generator(device=pdev)
    # the second child of the run seed's SeedSequence (the train step's
    # generator takes the seed itself)
    gen.manual_seed(int(np.random.SeedSequence(int(seed)).spawn(2)[1].generate_state(1, np.uint32)[0]))
    return mirror, pdev, gen
