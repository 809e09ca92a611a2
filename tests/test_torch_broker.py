"""The session broker of the PyTorch port (``sheeprl_tpu_torch/gateway/wal.py``,
``brokerd.py``, ``broker_client.py``) on the CPU.

* WAL, held against the JAX package's ``sheeprl_tpu/gateway/wal.py``: one op
  sequence through both ``WalStore``s writes byte-identical files (the live
  WAL and the compaction snapshot), and each package recovers the other's
  WAL to the same state; torn-tail truncation is prefix-exact at every byte
  offset of the last record; compaction, the stale-epoch refusal and the
  versioned get.
* The daemon and its client: roundtrip and ``stat``, an in-flight put
  replayed exactly once across a reconnect, the op deadline firing with no
  broker; standby promotion and zombie fencing held to the protocol (roles,
  epochs, versions, the promoted WAL's contents), and a spawned primary
  brokerd SIGKILLed under a client with zero acked loss. Every wait polls up
  to a generous limit and no test asserts a wall-clock duration beyond the
  op deadline's bound.
* ``build_broker``'s mode switch and the ``brokerd`` command composing its
  config.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import os
import pathlib
import signal
import time

import pytest

import sheeprl_tpu.gateway.wal as jwal
from sheeprl_tpu_torch.gateway.broker_client import BrokerClient, BrokerUnavailable
from sheeprl_tpu_torch.gateway.brokerd import BrokerServer, spawn_brokerd
from sheeprl_tpu_torch.gateway.wal import StaleEpoch, WalStore, frame_record, read_frames
from sheeprl_tpu_torch.telemetry.schema import validate_event

REPO = pathlib.Path(__file__).resolve().parent.parent
TOKEN = "test-token"
WAIT_S = 30.0  # the most any poll below waits: generous, never asserted as a duration


def _wal_path(store) -> pathlib.Path:
    return pathlib.Path(store._wal_path(store.gen))


def _server(store, role="primary", peer=None, lease_s=0.6, emit=None, **kw):
    return BrokerServer(store, token=TOKEN, port=0, role=role, peer=peer, lease_s=lease_s, hb_s=0.1,
                        log_every_s=0, emit=emit, **kw)


def _client(*ports, **kw):
    kw.setdefault("op_timeout_s", 10.0)
    return BrokerClient([("127.0.0.1", p) for p in ports], token=TOKEN, **kw)


def _wait(cond, limit_s=WAIT_S):
    deadline = time.monotonic() + limit_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


# -- the WAL, held against the JAX package ------------------------------------


def _ops(store):
    """One op sequence of every kind: puts (dedup'd replays among them),
    drops, an epoch bump and a compaction."""
    for i in range(12):
        store.put(f"s{i % 5}", f"blob-{i}" * (1 + i % 3), client_id=b"gw-a", client_seq=i + 1)
    store.put("s1", "replayed", client_id=b"gw-a", client_seq=4)  # a dedup hit: not applied
    store.drop("s3")
    store.bump_epoch()
    with store._lock:
        store._compact_locked()
    for i in range(4):
        store.put(f"t{i}", f"after-{i}", client_id=b"gw-b", client_seq=i + 1)
    store.put("s0", "last")


def _state(store, sids):
    return {sid: store.get(sid) for sid in sids}


SIDS = [f"s{i}" for i in range(5)] + [f"t{i}" for i in range(4)] + ["never"]


def test_wal_files_are_byte_identical_to_the_jax_package(tmp_path):
    stores = {"jax": jwal.WalStore(tmp_path / "jax", max_sessions=4, durability="wal"),
              "port": WalStore(tmp_path / "port", max_sessions=4, durability="wal")}
    for store in stores.values():
        _ops(store)
    states = {name: _state(store, SIDS) for name, store in stores.items()}
    for store in stores.values():
        store.close()
    assert states["port"] == states["jax"]
    files = {name: sorted(p.name for p in (tmp_path / name).iterdir()) for name in stores}
    assert files["port"] == files["jax"] and len(files["port"]) >= 2  # a snapshot and the live WAL
    for name in files["port"]:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_recovers_the_others_wal(tmp_path, writer):
    write_cls, read_cls = (jwal.WalStore, WalStore) if writer == "jax" else (WalStore, jwal.WalStore)
    store = write_cls(tmp_path / "w", max_sessions=4, durability="wal")
    _ops(store)
    want = _state(store, SIDS)
    store.close()
    recovered = read_cls(tmp_path / "w", max_sessions=4, durability="wal")
    try:
        assert _state(recovered, SIDS) == want
        assert recovered.epoch == 2 and recovered.torn_tails == 0
        # the dedup map came across too: a replayed put is not re-applied
        version = recovered.get("t0")[0]
        assert recovered.put("t0", "again", client_id=b"gw-b", client_seq=1) == version
    finally:
        recovered.close()


def test_wal_torn_tail_truncation_is_prefix_exact_at_every_byte_offset(tmp_path):
    store = WalStore(tmp_path / "base", max_sessions=64, durability="wal")
    for i in range(5):
        store.put(f"s{i % 3}", f"blob-{i}" * (i + 1), client_id=b"cli", client_seq=i)
    store.close()
    data = _wal_path(store).read_bytes()
    payloads, valid, torn = read_frames(data)
    assert len(payloads) == 5 and valid == len(data) and not torn
    tail_size = len(frame_record(payloads[-1]))
    tail_off = len(data) - tail_size
    prefix = WalStore(tmp_path / "prefix", max_sessions=64, durability="wal")
    for i in range(4):
        prefix.put(f"s{i % 3}", f"blob-{i}" * (i + 1), client_id=b"cli", client_seq=i)
    expected = _state(prefix, ("s0", "s1", "s2"))
    prefix.close()
    for cut in range(tail_off, len(data)):
        case_dir = tmp_path / f"cut_{cut}"
        case_dir.mkdir()
        (case_dir / _wal_path(store).name).write_bytes(data[:cut])
        events = []
        recovered = WalStore(case_dir, max_sessions=64, durability="wal", emit=events.append)
        assert _state(recovered, ("s0", "s1", "s2")) == expected, f"cut at byte {cut}"
        assert recovered.torn_tails == (0 if cut == tail_off else 1), f"cut at byte {cut}"
        assert (cut == tail_off) or any(r["action"] == "wal_torn_tail" for r in events)
        recovered.close()
        healed = WalStore(case_dir, max_sessions=64, durability="wal")
        assert healed.torn_tails == 0 and _state(healed, ("s0", "s1", "s2")) == expected
        healed.close()


def test_wal_compaction_stale_epoch_refusal_and_versioned_get(tmp_path):
    events = []
    store = WalStore(tmp_path / "c", max_sessions=4, durability="wal", compact_bytes=700, emit=events.append)
    for i in range(16):
        store.put(f"s{i}", f"payload-{i}" * 4)
    assert store.compactions >= 1 and any(r["action"] == "compact" for r in events)
    assert store.get("s15") == (1, "payload-15" * 4)
    assert store.get("s0") is None  # evicted before the compaction: compacted away
    store.close()
    recovered = WalStore(tmp_path / "c", max_sessions=4, durability="wal")
    assert recovered.get("s15") == (1, "payload-15" * 4) and recovered.get("s0") is None
    recovered.close()
    # fencing covers snapshots: a zombie's lower-epoch blob never rolls a promoted store back
    zombie = WalStore(tmp_path / "z", durability="wal", text=False)
    zombie.put("s", b"zombie-state")
    promoted = WalStore(tmp_path / "p", durability="wal", text=False)
    promoted.put("s", b"promoted-state")
    promoted.bump_epoch()
    with pytest.raises(StaleEpoch):
        promoted.load_state(zombie.encoded_state())
    assert promoted.get("s") == (1, b"promoted-state") and promoted.epoch == 2
    # two-deep history: the acked version is served, not the in-doubt one
    promoted.put("s", b"in-doubt")
    assert promoted.get("s") == (2, b"in-doubt") and promoted.get("s", at_version=1) == (1, b"promoted-state")
    assert promoted.get("s", at_version=99) == (2, b"in-doubt")
    for rec in events:
        assert validate_event(rec) == [], rec
    zombie.close()
    promoted.close()


# -- the daemon and its client --------------------------------------------------


def test_broker_client_roundtrip_stat_replay_and_deadline(tmp_path):
    store = WalStore(tmp_path, durability="wal", text=False)
    server = _server(store)
    cli = _client(server.port)
    try:
        assert cli.put("a", "A1") == 1 and cli.put("a", "A2") == 2
        assert cli.get("a") == (2, "A2") and cli.get("missing") is None and cli.version("a") == 2
        cli.drop("a")
        assert cli.get("a") is None
        stat = cli.stat()
        assert stat["role"] == "primary" and stat["puts"] == 2 and len(cli) == 0
        # applied, response lost: the replay after a reconnect is answered
        # from the dedup map with the original version, not re-applied
        assert cli.put("s", "v1-blob") == 1
        next_seq = cli._put_seq + 1
        store.put("s", "v2-blob", client_id=cli.client_id, client_seq=next_seq)
        with cli._lock:
            cli._drop_conn_locked("test: simulated link death")
        assert cli.put("s", "v2-blob") == 2
        assert store.get("s") == (2, b"v2-blob") and store.dedup_hits == 1
        assert cli.snapshot()["reconnects"] >= 1
    finally:
        cli.close()
        server.close()
    # no broker at all: every op fails with BrokerUnavailable at its deadline
    dead = BrokerClient([("127.0.0.1", 1)], token=TOKEN, op_timeout_s=0.5)
    with pytest.raises(BrokerUnavailable):
        dead.put("s", "blob")
    assert len(dead) == 0  # __len__ degrades, never raises
    dead.close()


def test_standby_promotes_on_lease_expiry_and_fences_the_zombie(tmp_path):
    from sheeprl_tpu_torch.resilience.chaos import ChaosInjector

    events_p, events_s = [], []
    p_store = WalStore(tmp_path / "p", durability="wal", text=False)
    primary = _server(p_store, emit=events_p.append, chaos=ChaosInjector(0, broker_zombie_at=3),
                      repl_timeout_s=2.0)
    s_store = WalStore(tmp_path / "s", durability="wal", text=False)
    standby = _server(s_store, role="standby", peer=("127.0.0.1", primary.port), emit=events_s.append)
    cli = _client(primary.port, standby.port, op_timeout_s=WAIT_S)
    try:
        assert _wait(lambda: len(primary._live_standbys()) == 1), "the standby never attached"
        for i in range(3):
            assert cli.put("x", f"X{i + 1}") == i + 1
        # sync replication: the standby's own store holds every acked put
        assert s_store.seq == p_store.seq and s_store.get("x") == (3, b"X3")
        # the primary stopped heartbeating at WAL seq 3: the standby promotes
        assert _wait(lambda: standby.current_role() == "primary"), "the standby never promoted"
        # the zombie still holds the client's link: its late write is fenced
        # by the promoted standby's epoch, never acked, and the client's
        # replay lands exactly once on the new primary
        assert cli.put("x", "X4") == 4
        assert cli.get("x") == (4, "X4")
        assert _wait(lambda: primary.current_role() == "demoted")
        assert s_store.epoch == 2 and s_store.get("x") == (4, b"X4")
        promotes = [r for r in events_s if r["action"] == "promote"]
        assert len(promotes) == 1 and promotes[0]["epoch"] == 2
        assert any(r["action"] == "fenced" for r in events_s)
        assert {"zombie", "demote"} <= {r["action"] for r in events_p}
        assert cli.snapshot()["max_epoch"] == 2
        for rec in events_p + events_s:
            assert validate_event(rec) == [], rec
    finally:
        cli.close()
        primary.close()
        standby.close()
    # the promoted WAL recovers to the acked trajectory at the new epoch
    recovered = WalStore(tmp_path / "s", durability="wal", text=False)
    assert recovered.get("x") == (4, b"X4") and recovered.epoch == 2
    recovered.close()


def test_brokerd_sigkill_primary_promotes_standby_with_zero_state_loss(tmp_path):
    spec = {"token": TOKEN, "role": "primary", "port": 0, "wal_dir": str(tmp_path / "p"), "durability": "wal",
            "lease_s": 0.6, "hb_s": 0.1, "log_every_s": 0.0}
    proc, port = spawn_brokerd(spec, timeout_s=WAIT_S)
    s_store = WalStore(tmp_path / "s", durability="wal", text=False)
    standby = _server(s_store, role="standby", peer=("127.0.0.1", port))
    cli = _client(port, standby.port, op_timeout_s=WAIT_S)
    try:
        assert _wait(lambda: cli.stat().get("standbys") == 1), "the standby never attached"
        acked = {}
        for i in range(10):
            acked[f"s{i % 3}"] = cli.put(f"s{i % 3}", f"blob-{i}")
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(timeout=WAIT_S)
        for sid, version in acked.items():
            entry = cli.get(sid)
            assert entry is not None and entry[0] == version, (sid, entry, version)
        assert cli.put("s0", "after-failover") == acked["s0"] + 1
        assert standby.current_role() == "primary"
    finally:
        cli.close()
        standby.close()
        if proc.is_alive():
            proc.kill()
        proc.join(timeout=WAIT_S)


def test_cluster_build_broker_mode_switch_and_cli_brokerd(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import Config, load_config_file
    from sheeprl_tpu_torch.gateway.broker import SessionBroker
    from sheeprl_tpu_torch.gateway.cluster import build_broker

    cfg = Config({"gateway": load_config_file(
        REPO / "sheeprl_tpu_torch" / "configs" / "gateway" / "default.yaml").to_dict()})
    assert isinstance(build_broker(cfg), SessionBroker)
    cfg.set_path("gateway.broker.wal_dir", str(tmp_path / "wal"))
    wal_broker = build_broker(cfg)
    assert isinstance(wal_broker, WalStore)
    assert wal_broker.put("s", "blob") == 1 and wal_broker.get("s") == (1, "blob")
    wal_broker.close()
    cfg.set_path("gateway.broker.mode", "external")
    with pytest.raises(ValueError, match="endpoints"):
        build_broker(cfg)
    cfg.set_path("gateway.broker.endpoints", ["127.0.0.1:19999"])
    ext = build_broker(cfg)
    assert isinstance(ext, BrokerClient)
    ext.close()
    cfg.set_path("gateway.broker.mode", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        build_broker(cfg)

    captured = {}
    monkeypatch.setattr("sheeprl_tpu_torch.gateway.brokerd.run_brokerd_from_cfg",
                        lambda cfg, block=True: captured.update(cfg=cfg))
    cli.brokerd(["gateway.broker.listen_port=0", "gateway.broker.role=standby"])
    assert captured["cfg"].select("gateway.broker.listen_port") == 0
    assert captured["cfg"].select("gateway.broker.role") == "standby"
    assert captured["cfg"].select("gateway.broker.durability") == "wal"
    assert cli.COMMANDS["brokerd"] is cli.brokerd
