"""Multi-replica serving gateway: sticky sessions, admission control, failover
(the port's counterpart of ``sheeprl_tpu/gateway/``).

    from sheeprl_tpu_torch.gateway import gateway_from_checkpoint
    gw = gateway_from_checkpoint("…/ckpt_1024.ckpt", cfg, block=False)
    # POST http://gw.host:gw.port/v1/act — same wire protocol as one replica

The split (MindSpeed-RL's decoupled dataflow, RLAX's versioned param fleets):

* **request-routing plane** — `Gateway` + `Router` + `AdmissionController`
  + `SessionBroker` (this package): admits, routes sticky sessions, sheds
  with jittered Retry-After, owns the authoritative session latents;
* **model-execution plane** — N `PolicyServer` replica processes under the
  `ReplicaManager` supervision tree (heartbeat watchdog, jittered-backoff
  respawn, fail budget → quarantine, rolling drain for hot reload).

Replicas serve on the card by default (``gateway.replica.platform=cuda``:
every replica's policy on ``cuda:0``); ``cpu`` keeps them on the host.
"""
from .admission import AdmissionController, Shed
from .broker import SessionBroker
from .broker_client import BrokerClient, BrokerUnavailable
from .cluster import build_broker, build_cluster, gateway_from_checkpoint, start_cluster
from .gateway import Gateway, GatewayStats, NoReplicasAvailable, Router
from .replica import ReplicaHandle, ReplicaManager, replica_entry, synthetic_counter_core
from .wal import WalStore

__all__ = [
    "AdmissionController",
    "BrokerClient",
    "BrokerUnavailable",
    "Gateway",
    "GatewayStats",
    "NoReplicasAvailable",
    "ReplicaHandle",
    "ReplicaManager",
    "Router",
    "SessionBroker",
    "Shed",
    "WalStore",
    "build_broker",
    "build_cluster",
    "gateway_from_checkpoint",
    "replica_entry",
    "start_cluster",
    "synthetic_counter_core",
]
