"""Deterministic fault injection for the actor fleet (``resilience.chaos.*``;
the port's own copy of ``sheeprl_tpu/resilience/chaos.py``; of the JAX
package's session-broker faults it keeps only the zombie primary,
``broker_zombie_at``, which the broker's fencing tests drive).

A seed-deterministic injector that the fleet worker processes (and the
supervisor's publication path) consult at well-defined points, so every
failure mode the supervisor handles — crash, hang, slow step, torn packet,
dropped param publication, and the socket transport's partition, in-flight
corruption, reset, half-open peer and latency — can be proved with a
reproducible trigger step.

Determinism contract: every trigger is an explicit lifetime counter
threshold from the config (``crash_at_step``, ``hang_at_step``, …), and the
only randomness (which bytes a torn packet flips, the latency jitter) is
drawn from ``seed``: the same config and seed always inject the same faults
at the same steps, so a chaos run replays exactly.

The injector is a plain picklable object: the supervisor builds one per
worker from the config and ships it into the worker process with the
spawn args. Worker-side hooks:

* :meth:`on_step` — called once per interaction slice with the worker's
  lifetime env-step counter; may terminate the process (``os._exit`` — a
  *hard* death, indistinguishable from an OOM-kill or segfault, which is
  the point) or sleep (hang / slow step);
* :meth:`corrupt` — called on the encoded packet bytes; flips bytes of the
  configured packet so the learner's checksum validation path is exercised;
* the ``net_*`` hooks of the socket channel (``fleet/net.py``).

Supervisor-side hook:

* :meth:`drops_publication` — returns True when the Nth param publication
  to this worker should be silently dropped (the worker keeps acting with
  stale params — the graceful-staleness path).
"""
from __future__ import annotations

import os
import random
import sys
import time
from typing import Any, List, Optional

__all__ = ["ChaosInjector", "chaos_from_cfg"]

# distinct exit code for an injected crash so tests / the supervisor's
# telemetry can tell a scripted death from a genuine one
CHAOS_EXIT_CODE = 73


def _as_int_list(val: Any) -> List[int]:
    if val is None:
        return []
    if isinstance(val, (int, float)):
        return [int(val)]
    return [int(v) for v in val]


class ChaosInjector:
    """Per-worker fault schedule. All thresholds are lifetime env-step (or
    packet / publication sequence) counters; ``0`` disables a fault."""

    def __init__(
        self,
        worker_id: int,
        *,
        crash_at_step: int = 0,
        crash_workers: Optional[List[int]] = None,
        crash_repeat: bool = False,
        hang_at_step: int = 0,
        hang_workers: Optional[List[int]] = None,
        hang_s: float = 3600.0,
        hang_repeat: bool = False,
        slow_step_ms: float = 0.0,
        slow_every: int = 0,
        torn_packet_at: int = 0,
        torn_workers: Optional[List[int]] = None,
        drop_publication_at: int = 0,
        drop_workers: Optional[List[int]] = None,
        net_partition_at: int = 0,
        net_partition_s: float = 2.0,
        net_corrupt_at: int = 0,
        net_reset_at: int = 0,
        net_half_open_at: int = 0,
        net_half_open_s: float = 2.0,
        net_latency_ms: float = 0.0,
        net_jitter_ms: float = 0.0,
        net_workers: Optional[List[int]] = None,
        broker_zombie_at: int = 0,
        seed: int = 0,
    ) -> None:
        self.worker_id = int(worker_id)
        self.crash_at_step = int(crash_at_step)
        self.crash_workers = _as_int_list(crash_workers)
        self.crash_repeat = bool(crash_repeat)
        self.hang_at_step = int(hang_at_step)
        self.hang_workers = _as_int_list(hang_workers)
        self.hang_s = float(hang_s)
        self.hang_repeat = bool(hang_repeat)
        self.slow_step_ms = float(slow_step_ms)
        self.slow_every = int(slow_every)
        self.torn_packet_at = int(torn_packet_at)
        self.torn_workers = _as_int_list(torn_workers)
        self.drop_publication_at = int(drop_publication_at)
        self.drop_workers = _as_int_list(drop_workers)
        # network faults (socket transport, fleet/net.py): thresholds are
        # DATA-packet sequence numbers — the one counter both sides of the
        # wire agree on — so a net chaos run replays exactly like the
        # process faults above
        self.net_partition_at = int(net_partition_at)
        self.net_partition_s = float(net_partition_s)
        self.net_corrupt_at = int(net_corrupt_at)
        self.net_reset_at = int(net_reset_at)
        self.net_half_open_at = int(net_half_open_at)
        self.net_half_open_s = float(net_half_open_s)
        self.net_latency_ms = float(net_latency_ms)
        self.net_jitter_ms = float(net_jitter_ms)
        self.net_workers = _as_int_list(net_workers)
        # session-broker fault (gateway/brokerd.py): the zombie threshold is
        # a WAL sequence number, the one counter primary, standby and
        # recovery all agree on
        self.broker_zombie_at = int(broker_zombie_at)
        self._net_partitioned = False
        self._net_corrupted = False
        self._net_reset = False
        self._net_half_opened = False
        self._net_rng: Optional[random.Random] = None  # lazy: one stream per injector
        self.seed = int(seed)
        self._hung = False
        # stamped by the supervisor at (re)spawn: without `crash_repeat` an
        # injected crash fires only in the first incarnation, so the respawn
        # proves recovery; with it every incarnation dies — the quarantine
        # driver
        self.incarnation = 0

    # -- targeting ---------------------------------------------------------
    def _is_target(self, workers: List[int]) -> bool:
        # empty per-fault list targets worker 0 — the deterministic default
        return self.worker_id in workers if workers else self.worker_id == 0

    # -- worker-side hooks ---------------------------------------------------
    def on_step(self, lifetime_step: int) -> None:
        """Consult the schedule before one interaction slice. May not return
        (crash) or may sleep (hang / slow step)."""
        if (
            self.crash_at_step > 0
            and lifetime_step >= self.crash_at_step
            and self._is_target(self.crash_workers)
            and (self.crash_repeat or self.incarnation == 0)
        ):
            print(
                f"[chaos] worker {self.worker_id}: injected crash at lifetime step "
                f"{lifetime_step} (incarnation {self.incarnation})",
                file=sys.stderr,
                flush=True,
            )
            os._exit(CHAOS_EXIT_CODE)  # hard death: no cleanup, no goodbye
        if (
            self.hang_at_step > 0
            and not self._hung
            and lifetime_step >= self.hang_at_step
            and self._is_target(self.hang_workers)
            and (self.hang_repeat or self.incarnation == 0)
        ):
            self._hung = True  # hang once per incarnation
            print(
                f"[chaos] worker {self.worker_id}: injected hang at lifetime step "
                f"{lifetime_step} ({self.hang_s:.0f}s)",
                file=sys.stderr,
                flush=True,
            )
            time.sleep(self.hang_s)
        if self.slow_step_ms > 0 and self.slow_every > 0 and lifetime_step > 0:
            if (lifetime_step // max(1, self.slow_every)) != (
                max(0, lifetime_step - 1) // max(1, self.slow_every)
            ):
                time.sleep(self.slow_step_ms / 1000.0)

    def corrupt(self, blob: bytes, packet_seq: int) -> bytes:
        """Return the (possibly torn) packet bytes for ``packet_seq``."""
        if (
            self.torn_packet_at > 0
            and packet_seq == self.torn_packet_at
            and self._is_target(self.torn_workers)
            and len(blob) > 8
        ):
            # int-derived seed: tuple seeding hashes, which is deprecated
            # (and hash-randomized across interpreters for str members)
            rng = random.Random(self.seed * 1_000_003 + self.worker_id * 1009 + packet_seq)
            torn = bytearray(blob)
            for _ in range(8):  # enough flips that the checksum cannot miss
                torn[rng.randrange(len(torn))] ^= 0xFF
            return bytes(torn)
        return blob

    # -- network hooks (worker-side socket channel, fleet/net.py) ------------
    def net_partitions(self, packet_seq: int) -> bool:
        """True exactly once, when the worker is about to transmit packet
        ``net_partition_at``: the channel severs the link and refuses to
        reconnect for ``net_partition_s`` seconds (the packet itself is
        delivered after the reconnect — nothing is lost, only delayed)."""
        if (
            self.net_partition_at > 0
            and packet_seq >= self.net_partition_at
            and not self._net_partitioned
            and self._is_target(self.net_workers)
            and self.incarnation == 0  # a respawned worker proved recovery
        ):
            self._net_partitioned = True
            return True
        return False

    def net_corrupt_wire(self, wire: bytes, packet_seq: int) -> bytes:
        """Byte-corrupt the FIRST transmission of packet ``net_corrupt_at``
        in flight (the clean bytes stay in the worker's replay buffer, so
        the learner's resync + RESEND recovers the packet uncorrupted)."""
        if (
            self.net_corrupt_at > 0
            and packet_seq == self.net_corrupt_at
            and not self._net_corrupted
            and self._is_target(self.net_workers)
            and self.incarnation == 0
            and len(wire) > 24
        ):
            self._net_corrupted = True
            rng = random.Random(self.seed * 1_000_003 + self.worker_id * 1013 + packet_seq)
            torn = bytearray(wire)
            # flip bytes past the magic so the frame parses far enough to
            # fail its CRC (not just vanish as line noise)
            for _ in range(8):
                torn[rng.randrange(8, len(torn))] ^= 0xFF
            return bytes(torn)
        return wire

    def net_resets(self, packet_seq: int) -> bool:
        """Abruptly drop the connection right AFTER packet ``net_reset_at``
        was transmitted — the frame is in flight but unacked, so the
        reconnect replays it and the learner-side dedup must drop it."""
        if (
            self.net_reset_at > 0
            and packet_seq == self.net_reset_at
            and not self._net_reset
            and self._is_target(self.net_workers)
            and self.incarnation == 0
        ):
            self._net_reset = True
            return True
        return False

    def net_half_opens(self, packet_seq: int) -> bool:
        """Stop reading from the socket for ``net_half_open_s`` after packet
        ``net_half_open_at`` — the connection stays ESTABLISHED but credits
        and ctrl frames pile up unread (the accept-but-never-read peer)."""
        if (
            self.net_half_open_at > 0
            and packet_seq == self.net_half_open_at
            and not self._net_half_opened
            and self._is_target(self.net_workers)
            and self.incarnation == 0
        ):
            self._net_half_opened = True
            return True
        return False

    def net_delay(self) -> None:
        """Added per-send latency (+ seeded jitter) on the data path. The
        jitter stream is seeded ONCE per injector so successive sends draw
        different offsets (reseeding per call would degenerate jitter into
        one constant)."""
        if self.net_latency_ms <= 0 or not self._is_target(self.net_workers):
            return
        delay = self.net_latency_ms
        if self.net_jitter_ms > 0:
            if self._net_rng is None:
                self._net_rng = random.Random(
                    self.seed * 1_000_003 + self.worker_id * 1013
                )
            delay += self._net_rng.uniform(0.0, self.net_jitter_ms)
        time.sleep(delay / 1000.0)

    # -- broker hook (gateway/brokerd.py) ------------------------------------
    def broker_zombies(self, wal_seq: int) -> bool:
        """True once the primary should STOP heartbeating while continuing
        to serve — the zombie whose post-promotion write the standby's
        fencing epoch must reject."""
        return self.broker_zombie_at > 0 and wal_seq >= self.broker_zombie_at

    # -- supervisor-side hook ------------------------------------------------
    def drops_publication(self, pub_seq: int) -> bool:
        return (
            self.drop_publication_at > 0
            and pub_seq == self.drop_publication_at
            and self._is_target(self.drop_workers)
        )

    @property
    def active(self) -> bool:
        return any(
            (
                self.crash_at_step,
                self.hang_at_step,
                self.slow_step_ms and self.slow_every,
                self.torn_packet_at,
                self.drop_publication_at,
                self.net_partition_at,
                self.net_corrupt_at,
                self.net_reset_at,
                self.net_half_open_at,
                self.net_latency_ms,
                self.broker_zombie_at,
            )
        )


def chaos_from_cfg(cfg: Any, worker_id: int, run_seed: int = 0) -> Optional[ChaosInjector]:
    """Build a worker's injector from ``resilience.chaos.*`` (None when the
    layer is disabled — the zero-overhead production default)."""
    sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)
    if not bool(sel("resilience.chaos.enabled", False)):
        return None
    seed = sel("resilience.chaos.seed")
    return ChaosInjector(
        worker_id,
        crash_at_step=int(sel("resilience.chaos.crash_at_step", 0) or 0),
        crash_workers=_as_int_list(sel("resilience.chaos.crash_workers", None)),
        crash_repeat=bool(sel("resilience.chaos.crash_repeat", False)),
        hang_at_step=int(sel("resilience.chaos.hang_at_step", 0) or 0),
        hang_workers=_as_int_list(sel("resilience.chaos.hang_workers", None)),
        hang_s=float(sel("resilience.chaos.hang_s", 3600.0) or 3600.0),
        hang_repeat=bool(sel("resilience.chaos.hang_repeat", False)),
        slow_step_ms=float(sel("resilience.chaos.slow_step_ms", 0.0) or 0.0),
        slow_every=int(sel("resilience.chaos.slow_every", 0) or 0),
        torn_packet_at=int(sel("resilience.chaos.torn_packet_at", 0) or 0),
        torn_workers=_as_int_list(sel("resilience.chaos.torn_workers", None)),
        drop_publication_at=int(sel("resilience.chaos.drop_publication_at", 0) or 0),
        drop_workers=_as_int_list(sel("resilience.chaos.drop_workers", None)),
        net_partition_at=int(sel("resilience.chaos.net_partition_at", 0) or 0),
        net_partition_s=float(sel("resilience.chaos.net_partition_s", 2.0) or 2.0),
        net_corrupt_at=int(sel("resilience.chaos.net_corrupt_at", 0) or 0),
        net_reset_at=int(sel("resilience.chaos.net_reset_at", 0) or 0),
        net_half_open_at=int(sel("resilience.chaos.net_half_open_at", 0) or 0),
        net_half_open_s=float(sel("resilience.chaos.net_half_open_s", 2.0) or 2.0),
        net_latency_ms=float(sel("resilience.chaos.net_latency_ms", 0.0) or 0.0),
        net_jitter_ms=float(sel("resilience.chaos.net_jitter_ms", 0.0) or 0.0),
        net_workers=_as_int_list(sel("resilience.chaos.net_workers", None)),
        seed=int(run_seed if seed is None else seed),
    )
