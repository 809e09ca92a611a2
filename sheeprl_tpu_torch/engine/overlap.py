"""Overlapped player/learner engine: concurrent acting and training with
bounded staleness (the port's own copy of ``sheeprl_tpu/engine/overlap.py``;
the packet trace spans of the JAX package's telemetry stream are left out
with that stream).

* the **player thread** steps the envs, acting against the
  :class:`~sheeprl_tpu_torch.parallel.placement.ParamMirror` copy of the
  weights, on a CUDA stream of its own when it acts on the card;
* the **learner thread** (the caller) drains transitions from a bounded
  SPSC queue into the replay buffer and runs the gradient bursts;
* **staleness is bounded**: a packet records how many bursts were claimed
  and not yet published when the player acted; the gate keeps that at most
  ``staleness_bound`` (0 = strict: the player never acts while a burst is
  unpublished);
* **replay-ratio accounting is exact**: the learner feeds the ``Ratio``
  controller one call per acknowledged packet, in FIFO order, with the same
  ``policy_step`` arguments the serial loop would have used.

Integration contract: a ``play_fn()`` closure records ONE env step's
replay-buffer mutations into a :class:`RecordingSink` and returns a
:class:`Packet`; the learner applies it with ``packet.apply(rb, aggregator)``
and calls ``engine.published()`` once per iteration, after the mirror
refresh when it trained.

RunGuard integration: the player stops feeding as soon as preemption is
requested (its waits poll ``guard.preempted``); the learner breaks at its own
``guard.stop_reached`` boundary and ``engine.shutdown(absorb)`` joins the
player and drains the queued packets into the buffer, so the final
checkpoint sees a buffer that matches the policy-step counter.

Stats: :meth:`OverlapEngine.maybe_emit` builds an ``overlap`` record of
the interval since the last one (player and learner stall, queue depth,
staleness) at most every ``stats_every_s``, writes it to the telemetry
stream (``telem.emit``), returns it and keeps it as ``last_record``; ``take``
calls it after every drain and ``shutdown`` at the end, as in the JAX
package.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = ["BufferOpSink", "OverlapEngine", "Packet", "RecordingSink", "SpscRing"]


class SpscRing:
    """Bounded single-producer / single-consumer ring queue. The producer
    only writes ``_tail``, the consumer only writes ``_head``; CPython int
    stores are atomic under the GIL, so the data path needs no lock."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._cap = int(capacity) + 1  # one slot sacrificed to tell full/empty
        self._buf: List[Any] = [None] * self._cap
        self._head = 0  # next slot to read (consumer-owned)
        self._tail = 0  # next slot to write (producer-owned)

    def __len__(self) -> int:
        return (self._tail - self._head) % self._cap

    @property
    def capacity(self) -> int:
        return self._cap - 1

    def try_put(self, item: Any) -> bool:
        nxt = (self._tail + 1) % self._cap
        if nxt == self._head:
            return False  # full
        self._buf[self._tail] = item
        self._tail = nxt  # publish after the slot is written
        return True

    def try_get(self) -> Any:
        """The next item, or the ring itself as the 'empty' sentinel (None
        is a legal item)."""
        head = self._head
        if head == self._tail:
            return self
        item = self._buf[head]
        self._buf[head] = None  # drop the reference so payloads don't linger
        self._head = (head + 1) % self._cap
        return item


class Packet:
    """One env-interaction slice crossing the player→learner queue."""

    __slots__ = ("payload", "env_steps", "version", "staleness")

    def __init__(self, payload: Any, env_steps: int):
        self.payload = payload
        self.env_steps = int(env_steps)
        self.version = 0  # published-params version the player acted with
        self.staleness = 0  # bursts unpublished at production time (<= bound)

    def apply(self, rb: Any, aggregator: Any = None) -> None:
        """Apply a :class:`RecordingSink` payload (buffer ops and deferred
        episode stats) to ``rb`` in production order; other payloads are a
        no-op."""
        if isinstance(self.payload, RecordingSink):
            self.payload.apply(rb, aggregator)


class BufferOpSink:
    """Pass-through sink of the serial loop: ops hit the buffer and the
    metric aggregator directly, with no copies. It shares the recorder's
    interface, so the interaction closure is written once for both loops."""

    __slots__ = ("rb", "aggregator")

    def __init__(self, rb: Any, aggregator: Any = None):
        self.rb = rb
        self.aggregator = aggregator

    def add(self, data: Dict[str, np.ndarray], idxes: Any = None, validate_args: bool = False) -> None:
        if idxes is None:
            self.rb.add(data, validate_args=validate_args)
        else:
            self.rb.add(data, idxes, validate_args=validate_args)

    def mark_restart(self, env_idx: int) -> None:
        if hasattr(self.rb, "mark_restart"):
            self.rb.mark_restart(int(env_idx))

    def stat(self, key: str, value: Any) -> None:
        if self.aggregator is not None:
            self.aggregator.update(key, value)


class RecordingSink:
    """Records replay-buffer mutations on the player thread, to be applied
    on the learner thread in the same order. ``add`` copies its arrays: the
    interaction closure reuses its ``step_data`` arrays across steps, and the
    learner may apply the op after the player has moved on. ``stat`` defers
    metric updates the same way: the aggregator is learner-only."""

    __slots__ = ("ops", "stats")

    def __init__(self) -> None:
        self.ops: List[tuple] = []
        self.stats: List[tuple] = []

    def add(self, data: Dict[str, np.ndarray], idxes: Any = None, validate_args: bool = False) -> None:
        self.ops.append(("add", {k: np.array(v, copy=True) for k, v in data.items()}, idxes, validate_args))

    def mark_restart(self, env_idx: int) -> None:
        self.ops.append(("restart", int(env_idx), None, False))

    def stat(self, key: str, value: Any) -> None:
        self.stats.append((key, value))

    def apply(self, rb: Any, aggregator: Any = None) -> None:
        for op, a, idxes, validate in self.ops:
            if op == "add":
                if idxes is None:
                    rb.add(a, validate_args=validate)
                else:
                    rb.add(a, idxes, validate_args=validate)
            elif hasattr(rb, "mark_restart"):
                rb.mark_restart(a)
        if aggregator is not None:
            for key, value in self.stats:
                aggregator.update(key, value)
        self.ops = []
        self.stats = []


_SLEEP_S = 0.0005  # park granularity of a blocked side (much less than one env step)


class OverlapEngine:
    """Concurrent player/learner driver with bounded staleness. Construct
    with :meth:`setup`; when ``enabled`` is False every method is a no-op."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        queue_depth: int = 4,
        staleness_bound: int = 1,
        stats_every_s: float = 5.0,
        total_steps: int = 0,
        initial_step: int = 0,
        guard: Any = None,
        telem: Any = None,
    ) -> None:
        self.enabled = bool(enabled)
        self.queue_depth = max(1, int(queue_depth))
        # 0 is legal: STRICT freshness, the player may not act while any
        # burst is unpublished
        self.staleness_bound = max(0, int(staleness_bound))
        self.stats_every_s = float(stats_every_s)
        self.total_steps = int(total_steps)
        self.initial_step = int(initial_step)
        self.guard = guard
        self.telem = telem

        self._ring = SpscRing(self.queue_depth)
        self._stop = threading.Event()
        self._player_done = threading.Event()
        self._player_exc: Optional[BaseException] = None
        self._exc_raised = False  # the player's exception already reached the learner
        self._thread: Optional[threading.Thread] = None

        # learner-owned counters (GIL-atomic int stores; the player only reads)
        self._burst_seq = 0  # bursts claimed
        self._pub_seq = 0  # bursts whose params are published
        self.acked_steps = 0  # env steps handed to the learner
        # player-owned counters (the learner only reads)
        self.produced_steps = 0
        self.packets_produced = 0

        # interval stats (reset at each record)
        self._stats_lock = threading.Lock()
        self._player_busy_s = 0.0
        self._player_stall_s = 0.0
        self._learner_stall_s = 0.0
        self._staleness_max = 0
        self.staleness_seen_max = 0  # whole-run high-water mark
        self._last_emit_t = time.perf_counter()
        self.last_record: Optional[Dict[str, Any]] = None

    @classmethod
    def setup(cls, cfg: Any, telem: Any = None, guard: Any = None, *, total_steps: int,
              initial_step: int = 0) -> "OverlapEngine":
        return cls(
            telem=telem,
            enabled=bool(cfg.algo.overlap.enabled),
            queue_depth=int(cfg.algo.overlap.queue_depth),
            staleness_bound=int(cfg.algo.overlap.staleness_bound),  # 0 is a legal bound
            stats_every_s=float(cfg.algo.overlap.stats_every_s),
            total_steps=total_steps,
            initial_step=initial_step,
            guard=guard,
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self, play_fn: Callable[[], Optional[Packet]]) -> "OverlapEngine":
        """Spawn the player thread. ``play_fn()`` performs one env slice and
        returns a Packet (or None to stop early)."""
        if not self.enabled or self._thread is not None:
            return self
        self.produced_steps = self.initial_step
        self.acked_steps = self.initial_step
        self._thread = threading.Thread(target=self._player_main, args=(play_fn,), name="overlap-player", daemon=True)
        self._thread.start()
        return self

    def _should_stop(self) -> bool:
        if self._stop.is_set():
            return True
        g = self.guard
        return g is not None and getattr(g, "preempted", False)

    def _player_main(self, play_fn: Callable[[], Optional[Packet]]) -> None:
        try:
            while not self._should_stop() and (self.total_steps <= 0 or self.produced_steps < self.total_steps):
                # backpressure BEFORE acting: wait for a free slot and for
                # the staleness gate, then collect the slice (waiting after
                # it would act one slice beyond the bound)
                t0 = time.perf_counter()
                while (
                    len(self._ring) >= self._ring.capacity or self._burst_seq - self._pub_seq > self.staleness_bound
                ) and not self._should_stop():
                    time.sleep(_SLEEP_S)
                gate_s = time.perf_counter() - t0
                if self._should_stop():
                    break

                t0 = time.perf_counter()
                pkt = play_fn()
                busy_s = time.perf_counter() - t0
                if pkt is None:
                    break
                pkt.version = self._pub_seq
                pkt.staleness = self._burst_seq - self._pub_seq

                t0 = time.perf_counter()
                # sole producer and a pre-checked free slot: immediate
                while not self._ring.try_put(pkt):
                    if self._should_stop():
                        return
                    time.sleep(_SLEEP_S)
                stall_s = (time.perf_counter() - t0) + gate_s

                self.produced_steps += pkt.env_steps
                self.packets_produced += 1
                with self._stats_lock:
                    self._player_busy_s += busy_s
                    self._player_stall_s += stall_s
                    self._staleness_max = max(self._staleness_max, pkt.staleness)
                    self.staleness_seen_max = max(self.staleness_seen_max, pkt.staleness)
        except BaseException as e:  # re-raised on the learner's next take()
            self._player_exc = e
        finally:
            self._player_done.set()

    # -- learner side ------------------------------------------------------
    def take(self, max_packets: int = 0) -> List[Packet]:
        """Drain available packets, blocking for the first one. Returns []
        when the player is done or stopped and the queue is empty. Raises if
        the player thread failed.

        A non-empty return CLAIMS a burst slot against the staleness gate,
        taken before the first packet leaves the ring; the learner releases
        it with :meth:`published` once per iteration."""
        out: List[Packet] = []
        t0 = time.perf_counter()
        stalled = 0.0
        claimed = False
        while True:
            if len(self._ring) > 0:
                if not claimed:
                    claimed = True
                    self._burst_seq += 1  # claim before the pop
                item = self._ring.try_get()
                if item is not self._ring:
                    out.append(item)
                    if max_packets and len(out) >= max_packets:
                        break
                    continue
            if out:
                break
            if self._player_exc is not None:
                self._raise_player_exc()
            if self._player_done.is_set() or self._should_stop():
                break
            time.sleep(_SLEEP_S)
            stalled = time.perf_counter() - t0
        if self._player_exc is not None and not out:
            self._raise_player_exc()
        with self._stats_lock:
            self._learner_stall_s += stalled
        for pkt in out:
            self.acked_steps += pkt.env_steps
        self.maybe_emit()
        return out

    def _raise_player_exc(self) -> None:
        self._exc_raised = True
        raise RuntimeError("overlap player thread crashed") from self._player_exc

    def burst_started(self) -> None:
        """Claim an EXTRA burst slot (a learner with more than one burst
        unpublished); ``take()`` already claims one per non-empty drain."""
        self._burst_seq += 1

    def published(self) -> None:
        """Release the claims: this iteration's params are published."""
        self._pub_seq = self._burst_seq

    # -- stats -------------------------------------------------------------
    def maybe_emit(self, force: bool = False, final: bool = False) -> Optional[Dict[str, Any]]:
        """The ``overlap`` record of the interval since the last one, once
        ``stats_every_s`` have passed (at once with ``force``), else None;
        ``final`` marks the run's last record (from ``shutdown``)."""
        if not self.enabled:
            return None
        now = time.perf_counter()
        elapsed = now - self._last_emit_t
        if not force and elapsed < self.stats_every_s:
            return None
        with self._stats_lock:
            busy, pstall, lstall = self._player_busy_s, self._player_stall_s, self._learner_stall_s
            stale_max = self._staleness_max
            self._player_busy_s = self._player_stall_s = self._learner_stall_s = 0.0
            self._staleness_max = 0
        self._last_emit_t = now
        denom = busy + pstall
        rec = {
            "event": "overlap",
            "step": int(self.acked_steps),
            "player_step": int(self.produced_steps),
            "queue_depth": int(len(self._ring)),
            "queue_cap": int(self.queue_depth),
            "packets": int(self.packets_produced),
            "bursts": int(self._pub_seq),
            "env_steps_ahead": int(self.produced_steps - self.acked_steps),
            "player_busy_s": busy,
            "player_stall_s": pstall,
            "learner_stall_s": lstall,
            "player_stall_frac": pstall / denom if denom > 0 else 0.0,
            "learner_stall_frac": lstall / elapsed if elapsed > 0 else 0.0,
            "staleness_max": int(stale_max),
            "interval_s": elapsed,
            "staleness_seen_max": int(self.staleness_seen_max),
        }
        if final:
            rec["final"] = True
        self.last_record = rec
        if self.telem is not None:
            self.telem.emit(rec)
        return rec

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, absorb: Optional[Callable[[Packet], None]] = None, timeout: float = 60.0) -> int:
        """Stop the player, join it, and drain queued packets through
        ``absorb`` (the learner-side buffer apply), so the final checkpoint
        sees every transition that crossed the queue. Returns the env steps
        drained. Raises if the player does not stop within ``timeout``, or
        if it failed and ``take()`` has not raised that yet. Safe to call
        twice or when disabled."""
        if not self.enabled:
            return 0
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)
            if thread.is_alive():
                raise RuntimeError(f"overlap player thread did not stop within {timeout:.0f}s")
        drained = 0
        while True:
            item = self._ring.try_get()
            if item is self._ring:
                break
            self.acked_steps += item.env_steps
            if absorb is not None:
                absorb(item)
                drained += item.env_steps
        self.maybe_emit(force=True, final=True)
        if self._player_exc is not None and not self._exc_raised:
            self._raise_player_exc()
        return drained
