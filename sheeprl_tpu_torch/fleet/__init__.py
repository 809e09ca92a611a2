"""Fault-tolerant actor fleet: supervised multi-process env workers (the
port's counterpart of ``sheeprl_tpu/fleet/``, worker mode).

N supervised worker processes each step a slice of the vector env with a
CPU copy of the policy and stream transition packets to the learner, with
param snapshots flowing the other way, as a supervision tree: crash →
respawn, hang → heartbeat escalation, repeated crasher → quarantine, SIGTERM
→ drain. The learner owns the replay buffer, the Ratio ledger and the train
step on the card.

Two transports share the same frames and supervision tree
(``fleet.transport``): ``mp`` — one-host bounded ``mp.Queue``s — and
``socket`` — length-prefixed TCP streams (``fleet/net.py``) with stream
resync, reconnect/replay/dedup and pull-based params; workers may attach
from other hosts (``python -m sheeprl_tpu_torch.fleet.remote``).

Enable per run with ``algo.fleet.workers=N`` (dreamer_v3 / sac / ppo); tune
the supervision under the root ``fleet`` config group and inject
deterministic faults with ``resilience.chaos.*``
(``sheeprl_tpu_torch/resilience/chaos.py``).
"""
from .engine import FleetEngine, FleetRound
from .protocol import FleetPacket, TornPacketError, WorkerChannel, decode_packet, encode_packet
from .supervisor import FleetSupervisor, WorkerHandle

__all__ = [
    "FleetEngine",
    "FleetPacket",
    "FleetRound",
    "FleetSupervisor",
    "TornPacketError",
    "WorkerChannel",
    "WorkerHandle",
    "decode_packet",
    "encode_packet",
]
