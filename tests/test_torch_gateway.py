"""The multi-replica serving gateway of the PyTorch port
(``sheeprl_tpu_torch/gateway/``) on the CPU.

* Decisions held against the JAX package's ``sheeprl_tpu/gateway/``: the
  admission controller and the sticky router take the same call sequences
  (sticky pins, freshness-aware placement, migration on a replica's death,
  an unacked placement, draining, the pin LRU bound, the depth gate, the
  token bucket's reserve, jittered ``Retry-After``) under the same
  ``random.seed`` in both packages and must decide the same, exactly.
* The protocol: 410 ``session_lost`` only for stateful sessions, the
  replica's idempotent replay of a duplicate forward, a retried forward
  whose first attempt executed never stepping the session twice, and a
  replica that captured an act and died before answering leaving only the
  retry's record to the capture reader.
* The ``gateway`` command composing its config; a chaos-killed synthetic
  replica failing over with zero acked loss (and doctor's ``replica_flap``);
  checkpoint replicas serving a tiny PPO checkpoint of the port with the
  greedy actions ``InferencePolicy`` gives on it; a ``platform=cpu``
  replica starting with no visible card, and a ``platform=cuda`` replica
  that finds none failing through the manager's fault path.

Replicas run with ``gateway.replica.platform=cpu``; every cluster is shut
down in ``finally``.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob
import json
import os
import pathlib
import random
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import sheeprl_tpu.gateway as jgw
import sheeprl_tpu.gateway.replica as jreplica
import sheeprl_tpu_torch.gateway as tgw
import sheeprl_tpu_torch.gateway.replica as treplica
from sheeprl_tpu_torch.gateway import Gateway, SessionBroker
from sheeprl_tpu_torch.gateway.replica import ReplicaManager
from sheeprl_tpu_torch.serve import InferencePolicy, MicroBatcher, PolicyServer

REPO = pathlib.Path(__file__).resolve().parent.parent
GATEWAY_YAML = REPO / "sheeprl_tpu_torch" / "configs" / "gateway" / "default.yaml"


# -- decisions held against the JAX package -----------------------------------


class _StubManager:
    def __init__(self, handles):
        self.handles = handles

    def routable(self, include_draining: bool = True):
        out = [h for h in self.handles if h.routable]
        if not include_draining:
            out = [h for h in out if not h.draining]
        return out


def _handles(mod, n, versions=None, draining=()):
    out = []
    for rid in range(n):
        h = mod.ReplicaHandle(rid)
        h.state, h.port, h.last_healthy = "running", 10000 + rid, time.monotonic()
        h.params_version = (versions or [0] * n)[rid]
        h.draining = rid in draining
        out.append(h)
    return out


def _route(router, sid, log):
    try:
        handle, needs_state, migrated = router.route(sid)
    except Exception as e:  # NoReplicasAvailable in either package
        log.append(("error", type(e).__name__))
        return None
    log.append((sid, handle.replica_id, needs_state, migrated))
    return handle


def _sticky_fresh(pkg, router_cls, log):
    h = _handles(pkg, 2, versions=[3, 5])
    router = router_cls(_StubManager(h))
    first = _route(router, "s1", log)
    router.confirm("s1", first)
    for _ in range(3):
        _route(router, "s1", log)
    h[0].params_version = 5
    _route(router, "s2", log)


def _migrate_on_death(pkg, router_cls, log):
    h = _handles(pkg, 2)
    router = router_cls(_StubManager(h))
    first = _route(router, "s1", log)
    router.confirm("s1", first)
    first.state = "backoff"
    other = _route(router, "s1", log)
    router.confirm("s1", other)
    first.state, first.last_healthy = "running", time.monotonic()
    first.incarnation += 1
    _route(router, "s1", log)


def _unacked_placement(pkg, router_cls, log):
    h = _handles(pkg, 2)
    router = router_cls(_StubManager(h))
    first = _route(router, "s1", log)
    router.confirm("s1", first)
    first.state = "backoff"
    _route(router, "s1", log)  # the forward to the survivor fails: no confirm
    _route(router, "s1", log)
    first.state, first.last_healthy = "running", time.monotonic()
    first.incarnation += 1
    routed = _route(router, "s1", log)
    router.confirm("s1", routed)
    _route(router, "s1", log)


def _draining(pkg, router_cls, log):
    h = _handles(pkg, 2, versions=[9, 1], draining=(0,))
    _route(router_cls(_StubManager(h)), "fresh", log)
    _route(router_cls(_StubManager([])), "x", log)


def _pin_lru(pkg, router_cls, log):
    h = _handles(pkg, 2)
    router = router_cls(_StubManager(h), max_pins=2)
    for sid in ("s1", "s2", "s3"):
        router.confirm(sid, _route(router, sid, log))
    log.append(("pins", router.pinned_sessions()))
    _route(router, "s1", log)
    with router._lock:
        log.append(("load", sorted(router._load.items())))


def _admission(adm_cls, shed_cls, log, calls, **kw):
    adm = adm_cls(**kw)
    for call in calls:
        if call == "release":
            adm.release()
            continue
        try:
            adm.admit(call)
            log.append(("admit", call))
        except shed_cls as e:
            log.append(("shed", call, e.reason, e.priority, e.retry_after_s))
    log.append(("snapshot", sorted(adm.snapshot().items())))


ROUTER_CASES = {"sticky_fresh": _sticky_fresh, "migrate_on_death": _migrate_on_death,
                "unacked_placement": _unacked_placement, "draining": _draining, "pin_lru": _pin_lru}
ADMISSION_CASES = {
    "depth_gate": (dict(rate_per_s=0.0, max_inflight=4, low_priority_frac=0.5),
                   ["normal", "normal", "low", "normal", "normal", "normal", "release", "normal", "low"]),
    "token_reserve": (dict(rate_per_s=0.001, burst=4, max_inflight=0, low_priority_frac=0.5),
                      ["low", "low", "low", "normal", "normal", "normal"]),
    "jittered_retry_after": (dict(rate_per_s=0.0, max_inflight=1, retry_after_s=0.5, jitter=0.5),
                             ["normal"] + ["normal"] * 20 + ["low"] * 5),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_decisions_equal_the_jax_package(case):
    logs = []
    for pkg, router_cls in ((jreplica, jgw.Router), (treplica, tgw.Router)):
        log: list = []
        random.seed(17)
        ROUTER_CASES[case](pkg, router_cls, log)
        logs.append(log)
    assert logs[1] == logs[0]
    assert len(logs[0]) >= 2


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_decisions_equal_the_jax_package(case, monkeypatch):
    import types

    import sheeprl_tpu.gateway.admission as jadmission
    import sheeprl_tpu_torch.gateway.admission as tadmission

    # one frozen clock for both controllers: the bucket's refill (and so a
    # rate-limit hint) is then a function of the call sequence alone
    for mod in (jadmission, tadmission):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda: 100.0))
    kw, calls = ADMISSION_CASES[case]
    logs = []
    for adm_cls, shed_cls in ((jgw.AdmissionController, jgw.Shed), (tgw.AdmissionController, tgw.Shed)):
        log: list = []
        random.seed(23)
        _admission(adm_cls, shed_cls, log, calls, **kw)
        logs.append(log)
    assert logs[1] == logs[0]  # the jittered Retry-After hints too, to the bit
    assert any(entry[0] == "shed" for entry in logs[0])


# -- the protocol ---------------------------------------------------------------


def _counter_policy(max_sessions: int = 4096) -> InferencePolicy:
    """The synthetic counter core of the replicas on the CPU: the action
    echoes the session's pre-step counter."""
    policy = InferencePolicy(treplica.synthetic_counter_core("cpu"), {"w": np.zeros((1,), np.float32)},
                             buckets=[1, 2])
    policy.warmup((True,))
    policy.sessions.max_sessions = max_sessions
    return policy


class _FakeManager:
    backoff_s = 0.1
    num_replicas = 1
    total_respawns = 0

    def __init__(self, handles):
        self.handles = handles

    def routable(self, include_draining: bool = True):
        return [h for h in self.handles if h.routable]

    def report_failure(self, replica_id, err=None):
        pass

    def alive_count(self):
        return len(self.handles)

    def quarantined_ids(self):
        return []


def _post_json(url: str, body: dict, timeout: float = 10.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_gateway_answers_410_session_lost_only_for_stateful_sessions(monkeypatch):
    (h0,) = _handles(treplica, 1)
    gw = Gateway(_FakeManager([h0]), broker=SessionBroker(max_sessions=1))
    responses: list = []
    monkeypatch.setattr(gw, "_post", lambda url, body, t: responses.pop(0))
    responses.append((200, {"actions": [[0.0]], "session_state": "blob-a"}, {}))
    status, body, _ = gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": "a"})
    assert status == 200 and body["session_version"] == 1
    # another session's blob evicts a's from the 1-deep broker, then a's
    # replica respawns: a migration with nothing to re-hydrate from
    gw.broker.put("b", "blob-b")
    h0.incarnation += 1
    status, body, _ = gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": "a"})
    assert status == 410 and body["error"] == "session_lost"
    assert gw.stats.snapshot()["lost"] == 1
    responses.append((200, {"actions": [[0.0]], "session_state": "blob-a2"}, {}))
    status, body, _ = gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": "a"})
    assert status == 200 and body["session_version"] == 1  # gone means gone: a new lineage
    responses.append((200, {"actions": [[0.0]]}, {}))
    assert gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": "s"})[0] == 200
    h0.incarnation += 1
    responses.append((200, {"actions": [[0.0]]}, {}))
    assert gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": "s"})[0] == 200
    assert gw.stats.snapshot()["lost"] == 1  # a stateless session loses nothing


def test_policy_server_idempotent_replay_and_410_rehydrate_protocol():
    policy = _counter_policy(max_sessions=2)
    server = PolicyServer(policy, MicroBatcher(policy, max_wait_ms=0.0), port=0)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        req = {"obs": {"x": [[0.0]]}, "session_id": "s", "request_id": "r1", "return_state": True}
        status, first = _post_json(f"{base}/v1/act", req)
        assert status == 200 and first["actions"] == [[0.0]]
        status, replay = _post_json(f"{base}/v1/act", req)
        assert status == 200 and replay == first and server.idempotent_replays == 1
        # a duplicate carrying a rehydration blob must not rewind the cache
        status, replay2 = _post_json(f"{base}/v1/act", dict(req, session_state=first["session_state"]))
        assert status == 200 and replay2["actions"] == [[0.0]]
        status, nxt = _post_json(f"{base}/v1/act", dict(req, request_id="r2"))
        assert status == 200 and nxt["actions"] == [[1.0]]
        # the 410 protocol: s falls off the 2-deep LRU, its blob re-hydrates it
        for sid in ("b", "c"):
            assert _post_json(f"{base}/v1/act", {"obs": {"x": [[0.0]]}, "session_id": sid})[0] == 200
        status, body = _post_json(f"{base}/v1/act", {"obs": {"x": [[0.0]]}, "session_id": "s"})
        assert status == 410 and body == {"error": "session_expired", "session_id": "s"}
        status, body = _post_json(f"{base}/v1/act", {"obs": {"x": [[0.0]]}, "session_id": "s",
                                                     "session_state": nxt["session_state"]})
        assert status == 200 and body["actions"] == [[2.0]]  # resumed, not reset
    finally:
        server.stop()


def test_gateway_retry_after_executed_timeout_never_double_steps():
    policy = _counter_policy()
    server = PolicyServer(policy, MicroBatcher(policy, max_wait_ms=0.0), port=0)
    server.start()
    try:
        (handle,) = _handles(treplica, 1)
        handle.port = server.port
        gw = Gateway(_FakeManager([handle]), broker=SessionBroker())
        real_post = Gateway._post
        armed = [True]

        def delayed_ack_post(url, body, timeout_s):
            if armed[0] and body.get("session_id") == "s":
                armed[0] = False
                real_post(gw, url, body, timeout_s)  # delivered and executed, the ack lost
                raise OSError("simulated: response lost after execution")
            return real_post(gw, url, body, timeout_s)

        gw._post = delayed_ack_post
        for want in (0.0, 1.0, 2.0):
            status, body, _ = gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": "s"})
            assert status == 200 and body["actions"] == [[want]]
        assert gw.stats.snapshot()["failovers"] == 1 and server.idempotent_replays == 1
    finally:
        server.stop()


def test_a_replica_killed_between_capture_and_answer_leaves_only_the_retrys_record(tmp_path):
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.flywheel import ingest, iter_capture_records
    from sheeprl_tpu_torch.flywheel.capture import CaptureWriter

    handles, servers = _handles(treplica, 2), []
    for rid, handle in enumerate(handles):
        policy = _counter_policy()
        capture = CaptureWriter(str(tmp_path / f"replica_{rid:03d}" / "capture.jsonl"), replica_id=rid)
        servers.append(PolicyServer(policy, MicroBatcher(policy, max_wait_ms=0.0), port=0, capture=capture))
        servers[-1].start()
        handle.port = servers[-1].port
    try:
        gw = Gateway(_FakeManager(handles), broker=SessionBroker())
        real_post, bodies = Gateway._post, []

        def dies_before_answering(url, body, timeout_s):
            bodies.append(dict(body))
            out = real_post(gw, url, body, timeout_s)
            if len(bodies) == 2:  # the second act stepped and was captured; its replica is gone
                next(h for h in handles if url.startswith(h.url)).state = "stopped"
                raise OSError("simulated: the replica died before answering")
            return out

        gw._post = dies_before_answering
        traces = [f"{k + 1:032x}" for k in range(3)]
        answers = []
        for trace in traces:
            status, body, _ = gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": "s",
                                             "traceparent": f"00-{trace}-{'1' * 16}-01"})
            assert status == 200
            answers.append(body)
        assert [b["actions"] for b in answers] == [[[0.0]], [[1.0]], [[2.0]]]
        assert answers[1]["replica"] != answers[0]["replica"]  # the retry ran on the survivor
        assert "attempt" not in bodies[1] and bodies[2]["attempt"] == 1
        assert bodies[2]["request_id"] == bodies[1]["request_id"]
        assert bodies[2]["traceparent"].split("-")[1] == bodies[1]["traceparent"].split("-")[1] == traces[1]
    finally:
        for server in servers:
            server.stop()
    raw = [json.loads(line) for path in sorted(tmp_path.glob("replica_*/capture.jsonl")) for line in open(path)]
    assert sorted(r["trace_id"] for r in raw if r["event"] == "capture") == sorted([traces[0], *traces[1:2] * 2,
                                                                                   traces[2]])
    kept = list(iter_capture_records(tmp_path))
    assert sorted(r["trace_id"] for r in kept) == traces
    retried = [r for r in kept if r["trace_id"] == traces[1]]
    assert len(retried) == 1 and retried[0]["attempt"] == 1 and retried[0]["replica"] == answers[1]["replica"]
    assert {r["trace_id"]: r["actions"] for r in kept} == {t: b["actions"] for t, b in zip(traces, answers)}
    assert ingest(tmp_path, ReplayBuffer(10, n_envs=1))["samples"] == 3


def test_cli_gateway_composes_gateway_config(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli

    (tmp_path / "checkpoint").mkdir()
    ckpt = tmp_path / "checkpoint" / "ckpt_8.ckpt"
    ckpt.write_bytes(b"\x00")
    (tmp_path / "config.yaml").write_text("algo:\n  name: ppo\nseed: 0\n")
    captured = {}
    monkeypatch.setattr("sheeprl_tpu_torch.gateway.cluster.gateway_from_checkpoint",
                        lambda ckpt_path, cfg, block=True: captured.update(ckpt=ckpt_path, cfg=cfg))
    cli.gateway([f"checkpoint_path={ckpt}", "gateway.replicas=5"])
    cfg = captured["cfg"]
    assert cfg.select("gateway.replicas") == 5
    assert cfg.select("gateway.replica.platform") == "cuda"  # the port's replicas serve on the card
    assert cfg.select("gateway.admission.burst") == 256 and cfg.select("gateway.supervisor.max_fails") == 3
    assert cfg.select("serve.capture.enabled") is False  # the serve group composed too
    assert cli.COMMANDS["gateway"] is cli.gateway


# -- clusters of real replica processes ----------------------------------------


def _gateway_cfg(extra: dict):
    from sheeprl_tpu_torch.config import Config, load_config_file

    cfg = Config({"gateway": load_config_file(GATEWAY_YAML).to_dict()})
    for key, val in {"gateway.replicas": 2, "gateway.http.port": 0, "gateway.replica.platform": "cpu",
                     "gateway.supervisor.health_poll_s": 0.1, **extra}.items():
        cfg.set_path(key, val)
    return cfg


def _drive_sessions(gw, expected, rounds, mismatches):
    for _ in range(rounds):
        for sid in list(expected):
            status, body, _ = gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": sid})
            if status != 200:
                continue  # unacked: the counter must not advance
            action = float(body["actions"][0][0])
            if action != float(expected[sid]):
                mismatches.append((sid, expected[sid], action))
            expected[sid] = int(action) + 1


def test_gateway_failover_e2e_chaos_kill_zero_acked_loss(tmp_path):
    from sheeprl_tpu_torch.diag.findings import run_detectors
    from sheeprl_tpu_torch.diag.timeline import Timeline, iter_events
    from sheeprl_tpu_torch.gateway.cluster import build_cluster
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl
    from sheeprl_tpu.telemetry.schema import validate_jsonl as jax_validate_jsonl
    from sheeprl_tpu_torch.telemetry.sinks import JsonlSink

    cfg = _gateway_cfg({"gateway.supervisor.backoff_s": 0.2, "gateway.supervisor.jitter": 0.1,
                        # replica 0 os._exits on its 30th act request, first incarnation only
                        "gateway.replica.chaos": {"crash_at_step": 30}, "gateway.telemetry.log_every_s": 0.5})
    tele = tmp_path / "telemetry.jsonl"
    sink = JsonlSink(str(tele))
    gw = build_cluster(cfg, sink=sink, start=True, telemetry_dir=tmp_path)
    manager = gw.manager
    try:
        assert len(manager.routable()) == 2
        expected = {f"s{i:02d}": 0 for i in range(24)}
        mismatches: list = []
        _drive_sessions(gw, expected, rounds=6, mismatches=mismatches)
        deadline = time.monotonic() + 60.0
        while manager.crashes < 1 and time.monotonic() < deadline:
            _drive_sessions(gw, expected, rounds=1, mismatches=mismatches)
        assert manager.crashes >= 1, "chaos crash never observed"
        _drive_sessions(gw, expected, rounds=3, mismatches=mismatches)
        assert manager.wait_routable(timeout_s=60.0), "replica never respawned"
        _drive_sessions(gw, expected, rounds=2, mismatches=mismatches)
        assert mismatches == [], f"acked-request loss: {mismatches[:5]}"
        stats = gw.stats.snapshot()
        assert stats["migrations"] > 0 and stats["rehydrates"] > 0
        assert gw.health()["routable"] == 2
        assert all(v >= 10 for v in expected.values())
    finally:
        gw.stop()
        manager.shutdown()
        sink.close()
    assert validate_jsonl(tele) == [] and jax_validate_jsonl(tele) == []
    for stream in glob.glob(str(tmp_path / "replicas" / "*" / "telemetry.jsonl")):
        assert validate_jsonl(stream) == [] and jax_validate_jsonl(stream) == [], stream
    tl = Timeline(list(iter_events(tele)))
    actions = [r.get("action") for r in tl.of("replica")]
    assert "crash" in actions and "respawn" in actions and actions.count("ready") >= 3
    findings = {f.code: f for f in run_detectors(tl)}
    flap = findings["replica_flap"]
    assert flap.data["faults"] >= 1 and flap.data["migrations"] > 0 and flap.severity == "warning"


PPO_ARGS = ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "algo.rollout_steps=8",
            "algo.per_rank_batch_size=4", "algo.update_epochs=1", "algo.mlp_keys.encoder=[state]",
            "algo.cnn_keys.encoder=[]", "algo.dense_units=8", "algo.mlp_layers=1", "algo.total_steps=32",
            "algo.run_test=False", "buffer.memmap=False", "metric.log_level=0", "checkpoint.every=16",
            "fabric.accelerator=cpu"]


def test_gateway_checkpoint_replicas_answer_the_inference_policy_greedy_actions(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import CONFIG_ROOT, load_config_file
    from sheeprl_tpu_torch.gateway.cluster import build_cluster

    monkeypatch.chdir(tmp_path)
    cli.run(PPO_ARGS)
    ckpt = pathlib.Path(sorted(glob.glob("logs/runs/ppo/discrete_dummy/*/version_*/checkpoint/ckpt_*.ckpt"),
                               key=lambda p: int(pathlib.Path(p).stem.split("_")[1]))[-1]).resolve()
    cfg = load_config_file(ckpt.parent.parent / "config.yaml")
    for group in ("serve", "gateway"):
        cfg[group] = load_config_file(CONFIG_ROOT / group / "default.yaml")
    for key, val in {"gateway.replicas": 2, "gateway.http.port": 0, "gateway.replica.platform": "cpu",
                     "gateway.supervisor.health_poll_s": 0.1, "gateway.telemetry.live": False}.items():
        cfg.set_path(key, val)
    reference = InferencePolicy.from_checkpoint(ckpt, cfg=load_config_file(ckpt.parent.parent / "config.yaml"))
    rng = np.random.default_rng(3)
    observations = [rng.uniform(-3, 3, size=(10,)).astype(np.float32) for _ in range(12)]
    gw = build_cluster(cfg, ckpt_path=ckpt, start=True)
    try:
        assert len(gw.manager.routable()) == 2
        served = []
        for i, obs in enumerate(observations):
            status, body, _ = gw.handle_act({"obs": {"state": obs.tolist()}, "deterministic": True,
                                             "session_id": f"s{i % 4}"})
            assert status == 200, body
            served.append(np.asarray(body["actions"]))
        assert {h.replica_id for h in gw.manager.handles if gw.router._load.get(h.replica_id)} == {0, 1}
    finally:
        gw.stop()
        gw.manager.shutdown()
    for obs, got in zip(observations, served):
        want = reference.act({"state": obs}, deterministic=True)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_replica_platforms_cpu_hides_the_card_and_cuda_without_one_faults(tmp_path, capfd):
    assert treplica.replica_env("cpu") == {"CUDA_VISIBLE_DEVICES": ""} and treplica.replica_env("cuda") == {}
    with pytest.raises(ValueError, match="platform"):
        ReplicaManager({"mode": "synthetic"}, num_replicas=1, replica_platform="tpu")
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    events: list = []

    class _Sink:
        def write(self, rec):
            events.append(rec)

    cpu = ReplicaManager({"mode": "synthetic"}, num_replicas=1, sink=_Sink(), replica_platform="cpu",
                         health_poll_s=0.1)
    cpu.start()
    try:
        assert cpu.wait_routable(timeout_s=60.0)
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == before  # the gateway's own environment is restored
        environ = pathlib.Path(f"/proc/{cpu.handles[0].proc.pid}/environ").read_bytes().split(b"\0")
        assert b"CUDA_VISIBLE_DEVICES=" in environ  # the replica's interpreter sees no card
    finally:
        cpu.shutdown()
    if torch.cuda.is_available():
        return  # the no-card fault path needs a machine without a card
    cuda = ReplicaManager({"mode": "synthetic"}, num_replicas=1, sink=_Sink(), replica_platform="cuda",
                          spawn_grace_s=60.0)
    cuda._spawn(cuda.handles[0])  # no monitor thread: this test sweeps itself
    try:
        proc = cuda.handles[0].proc
        proc.join(timeout=60.0)
        assert proc.exitcode not in (None, 0)
        cuda.monitor_once()
        assert cuda.crashes == 1 and cuda.handles[0].state == "backoff"
        assert any(r.get("action") == "crash" for r in events)
    finally:
        cuda.shutdown()
    assert "sees no CUDA device" in capfd.readouterr().err
