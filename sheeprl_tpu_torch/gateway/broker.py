"""SessionBroker: the authoritative copy of every session's latent (the port's
counterpart of ``sheeprl_tpu/gateway/broker.py``).

A replica's :class:`~sheeprl_tpu_torch.serve.policy.SessionStore` is just a cache
once a gateway fronts the fleet — the broker owns the truth. Every acked
``/v1/act`` response carries the session's updated state blob, which the
gateway writes here *before* acknowledging the client; on replica death (or
a 410 ``session_expired`` from an LRU-evicted cache entry) the broker's copy
re-hydrates the session on a survivor. Because the broker only advances on
acked responses, a request that died in flight is retried from the last
acked state — the client-observable trajectory never skips or replays an
acked step.

Entries are ``(version, blob)``: ``version`` is a per-session monotonic
counter (how many acked steps the broker has absorbed), ``blob`` the opaque
base64 codec string (`serve/session_codec.py`) exactly as the replica
produced it — the gateway never decodes latents, it routes them.

This class is the plain IN-PROCESS implementation (``gateway.broker.mode=
inproc`` without a WAL) — everything here dies with the gateway process and
an LRU eviction is forever. The durable/replicated variants share its
surface: :class:`~sheeprl_tpu_torch.gateway.wal.WalStore` (WAL-backed, rehydrates
evicted-but-durable sessions) and
:class:`~sheeprl_tpu_torch.gateway.broker_client.BrokerClient` (the externalized
``brokerd`` daemon pair). ``cluster.build_broker`` picks one from config.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

__all__ = ["SessionBroker"]


class SessionBroker:
    """Thread-safe LRU-bounded session_id → (version, blob) map."""

    def __init__(self, max_sessions: int = 1_000_000) -> None:
        self.max_sessions = int(max_sessions)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[int, str]]" = OrderedDict()
        self.evictions = 0

    def put(self, sid: str, blob: str) -> int:
        """Absorb one acked step's updated latent; returns the new version."""
        sid = str(sid)
        with self._lock:
            version = self._entries.pop(sid, (0, ""))[0] + 1
            self._entries[sid] = (version, blob)
            while len(self._entries) > self.max_sessions:
                self._entries.popitem(last=False)
                self.evictions += 1
            return version

    def get(self, sid: str, at_version: int = 0) -> Optional[Tuple[int, str]]:
        """The newest (version, blob) for a session, bumping its recency;
        None for sessions the broker has never acked (or has evicted).
        ``at_version`` exists for surface parity with the durable brokers
        and is ignored here: an in-process put is atomic with the ack, so
        the newest entry is by construction the last ACKED one."""
        with self._lock:
            entry = self._entries.get(str(sid))
            if entry is not None:
                self._entries.move_to_end(str(sid))
            return entry

    def version(self, sid: str) -> int:
        entry = self.get(sid)
        return entry[0] if entry is not None else 0

    def drop(self, sid: str) -> None:
        with self._lock:
            self._entries.pop(str(sid), None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
