"""The data flywheel of the PyTorch port (``sheeprl_tpu_torch/flywheel/``) on
the CPU, held against the JAX package's ``sheeprl_tpu/flywheel/``.

* Capture: ``session_sampled`` agrees on 1,000 ids at several fractions; the
  same acts through both ``CaptureWriter``s give the same records (the
  wall-clock ``t`` held fixed, so byte for byte) and the same rotated
  segments.
* Ingest: segments written by the JAX package's writer, with a torn tail,
  two replicas and stale versions, go through both ``ingest``s into each
  package's ``ReplayBuffer``: the buffer columns bitwise, the summaries'
  counts exactly, the ledger JSON exactly, and all of it again on a rerun.
* Recipe: a ``synthetic_counter`` turn gives the same ``w`` exactly; the
  greedy-BC fallback on the reference's linear core (each package in its own
  tensors) gives each step's loss and ``w`` within rel 1e-6 (f32), and its
  run pulls ``w`` to the captured actions; an unknown algo fails before the
  ledger consumes anything; the port's flywheel checkpoint (``torch.save``)
  loads through the port's ``CheckpointReloader``; the ``flywheel`` command
  composes its config and takes a turn; a synthetic replica seeds from and
  watches its checkpoint dir; the cluster refuses capture with no directory.
* The miniature loop through a 2-replica gateway on the CPU (capture on):
  48 samples, ``ckpt_3.ckpt``, versions {0} then {1}, re-ingest 24 new / 48
  duplicates, then 0 / 72.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import json
import pathlib
import shutil
import types

import numpy as np
import pytest
import torch

import sheeprl_tpu.flywheel as jfw
import sheeprl_tpu.flywheel.capture as jcapture
import sheeprl_tpu_torch.flywheel as tfw
import sheeprl_tpu_torch.flywheel.capture as tcapture
from sheeprl_tpu.config import Config as JConfig
from sheeprl_tpu.data.buffers import ReplayBuffer as JReplayBuffer
from sheeprl_tpu_torch.config import Config, load_config_file
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.telemetry.schema import validate_event

REPO = pathlib.Path(__file__).resolve().parent.parent
GATEWAY_YAML = REPO / "sheeprl_tpu_torch" / "configs" / "gateway" / "default.yaml"
REL = 1e-6
# what a summary holds that is not a count: the pass's own speed and time
TIMED = ("samples_per_s", "duration_s")


def _frozen_clock(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 1760000000.125, monotonic=__import__("time").monotonic)
    for mod in (jcapture, tcapture):
        monkeypatch.setattr(mod, "time", clock)


def _acts(writer, sessions=3, steps=10, version=0, reward=0.5, stale_every=0):
    for i in range(steps):
        for s in range(sessions):
            v = version - 5 if stale_every and i % stale_every == 0 else version
            assert writer.record(f"s{s}", {"x": [[float(i)]], "y": [float(s), 1.0]}, [[float(i), -float(s)]],
                                 params_version=v, trace_id=f"tr-{s}-{i}", reward=reward + i, done=i == steps - 1)


def _jax_capture(root: pathlib.Path, torn: bool = True) -> None:
    """Two replicas' segments from the JAX package's writer: rotated, with
    stale versions among them and (optionally) a torn last line."""
    for replica in (0, 1):
        w = jcapture.CaptureWriter(str(root / f"replica_{replica:03d}" / "capture.jsonl"), max_bytes=2500,
                                   replica_id=replica)
        _acts(w, sessions=2 + replica, steps=9, version=6, stale_every=3)
        w.close()
    if torn:
        with open(root / "replica_001" / "capture.jsonl", "a") as fh:
            fh.write('{"event": "capture", "session_id": "s0", "st')


# -- capture -----------------------------------------------------------------


def test_session_sampled_agrees_with_the_jax_package():
    ids = [f"user-{i}" for i in range(1000)]
    for frac in (0.0, 0.1, 0.25, 0.5, 0.9, 1.0):
        assert [tcapture.session_sampled(s, frac) for s in ids] == [jcapture.session_sampled(s, frac) for s in ids]
    assert 200 < sum(tcapture.session_sampled(s, 0.25) for s in ids) < 300


def test_capture_writers_write_the_same_records_and_segments(tmp_path, monkeypatch):
    _frozen_clock(monkeypatch)
    for name, mod in (("jax", jcapture), ("port", tcapture)):
        w = mod.CaptureWriter(str(tmp_path / name / "capture.jsonl"), max_bytes=1500, replica_id=2, incarnation=1)
        _acts(w, sessions=2, steps=12)
        assert not w.record(None, {"x": [[0.0]]}, [[0.0]], 0)  # sessionless: never captured
        assert w.snapshot() == {"captured": 24, "skipped": 1, "errors": 0, "sessions": 2}
        w.close()
    segments = {name: sorted(p.name for p in (tmp_path / name).iterdir()) for name in ("jax", "port")}
    assert segments["port"] == segments["jax"] and len(segments["port"]) > 2, "rotation never triggered"
    for seg in segments["port"]:
        # a rotate marker names its segment's path: the same but for the directory
        port_lines = (tmp_path / "port" / seg).read_text().replace(str(tmp_path / "port"), "<dir>").splitlines()
        assert port_lines == (tmp_path / "jax" / seg).read_text().replace(str(tmp_path / "jax"), "<dir>").splitlines()
        for line in port_lines:
            assert validate_event(json.loads(line)) == []


# -- ingest ------------------------------------------------------------------


def _buffer_columns(rb, n):
    return {k: np.asarray(rb[k])[:n] for k in sorted(rb.keys())}


@pytest.mark.parametrize("gate", [None, 2])
def test_ingest_equals_the_jax_package(tmp_path, gate):
    _jax_capture(tmp_path / "src")
    for name in ("jax", "port"):
        shutil.copytree(tmp_path / "src", tmp_path / name)
    out = {}
    rbs = {"jax": JReplayBuffer(500, n_envs=1), "port": ReplayBuffer(500, n_envs=1)}
    for name, mod in (("jax", jfw), ("port", tfw)):
        events: list = []
        out[name] = mod.ingest(tmp_path / name, rbs[name], max_version_lag=gate, emit=events.append)
        assert len(events) == 1 and validate_event(events[0]) == []
    summary = {k: v for k, v in out["port"].items() if k not in TIMED}
    assert summary == {k: v for k, v in out["jax"].items() if k not in TIMED}
    assert out["port"]["torn_lines"] == 1 and out["port"]["samples"] > 0
    assert (out["port"]["dropped_stale"] > 0) == (gate is not None)
    n = out["port"]["samples"]
    jcols, tcols = _buffer_columns(rbs["jax"], n), _buffer_columns(rbs["port"], n)
    assert list(tcols) == list(jcols)
    for k in jcols:
        assert tcols[k].dtype == jcols[k].dtype and np.array_equal(tcols[k], jcols[k]), k
    ledger = {name: (tmp_path / name / "ingest_ledger.json").read_text() for name in ("jax", "port")}
    assert ledger["port"] == ledger["jax"]
    # the rerun: nothing new, everything a duplicate, the ledger unchanged
    again = {name: mod.ingest(tmp_path / name, buf(100, n_envs=1), max_version_lag=gate)
             for name, mod, buf in (("jax", jfw, JReplayBuffer), ("port", tfw, ReplayBuffer))}
    assert {k: v for k, v in again["port"].items() if k not in TIMED} == \
        {k: v for k, v in again["jax"].items() if k not in TIMED}
    assert again["port"]["samples"] == 0 and again["port"]["duplicates"] == n + out["port"]["dropped_stale"]
    assert (tmp_path / "port" / "ingest_ledger.json").read_text() == (tmp_path / "jax" / "ingest_ledger.json").read_text()


# -- recipe ------------------------------------------------------------------


def test_synthetic_counter_turn_equals_the_jax_package(tmp_path):
    import pickle

    fw = {"steps": 5, "batch_size": 8, "lr": 0.5, "max_version_lag": 4, "buffer_size": 1000,
          "algo": "synthetic_counter", "seed": 3}
    out, w = {}, {}
    for name, mod, cfg_cls in (("jax", jfw, JConfig), ("port", tfw, Config)):
        _jax_capture(tmp_path / name / "capture", torn=False)
        seed = mod.write_checkpoint(tmp_path / name / "checkpoint", 4, {"params": {"w": np.zeros((1,), np.float32)}})
        out[name] = mod.run_flywheel(tmp_path / name, seed, cfg=cfg_cls({"flywheel": dict(fw)}))
        assert out[name]["checkpoint"].endswith("ckpt_9.ckpt")
    w["jax"] = pickle.loads(pathlib.Path(out["jax"]["checkpoint"]).read_bytes())["params"]["w"]
    w["port"] = torch.load(out["port"]["checkpoint"], weights_only=False)["params"]["w"]
    assert np.asarray(w["port"]).dtype == np.float32 and np.array_equal(np.asarray(w["port"]), np.asarray(w["jax"]))
    assert out["port"]["finetune"] == out["jax"]["finetune"]
    assert {k: v for k, v in out["port"]["ingest"].items() if k not in TIMED} == \
        {k: v for k, v in out["jax"]["ingest"].items() if k not in TIMED}
    assert out["port"]["reload"] == {"mode": "poll", "results": None}
    # the turn's own stream: ingest, finetune and reload, valid for both packages
    from sheeprl_tpu.telemetry.schema import validate_jsonl as jax_validate_jsonl
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    stream = tmp_path / "port" / "flywheel" / "telemetry.jsonl"
    actions = [json.loads(line)["action"] for line in stream.read_text().splitlines()]
    assert actions == ["ingest", "finetune", "reload"]
    assert validate_jsonl(stream) == [] and jax_validate_jsonl(stream) == []


def _linear_cores():
    from sheeprl_tpu.serve.policy import PolicyCore as JPolicyCore
    from sheeprl_tpu_torch.serve.policy import PolicyCore

    jcore = JPolicyCore(
        apply=lambda params, obs, state, key, greedy: (obs["x"] * params["w"], state, key),
        extract_params=lambda p: p,
        prepare=lambda raw, n: {"x": np.asarray(raw["x"], np.float32).reshape(n, -1)},
        dummy_obs=lambda n: {"x": np.zeros((n, 1), np.float32)},
        name="bc_linear",
    )
    tcore = PolicyCore(
        apply=lambda params, obs, state, noise, greedy: (obs["x"] * params["w"], state),
        extract_params=lambda p: p,
        prepare=lambda raw, n: {"x": np.asarray(raw["x"], np.float32).reshape(n, -1)},
        dummy_obs=lambda n: {"x": np.zeros((n, 1), np.float32)},
        draw_noise=lambda generator, n: None,
        device=torch.device("cpu"),
        name="bc_linear",
    )
    return jcore, tcore


def _bc_batch(rng, n=8):
    """The reference test's rows (obs x=1, action 2) among rows at x=0.5 and
    x=2: powers of two, so ``x * w`` is exact in f32 and the packages' one
    difference is the order of the means' sums."""
    x = rng.choice(np.asarray([0.5, 1.0, 1.0, 2.0], np.float32), size=(n, 1))
    actions = np.where(x == 1.0, 2.0, rng.choice(np.asarray([1.0, 1.5, 3.0], np.float32), size=(n, 1)))
    zeros = np.zeros((n, 1), np.float32)
    return {"x": x, "actions": actions.astype(np.float32), "rewards": zeros, "dones": zeros,
            "params_version": zeros.astype(np.int32), "capture_step": zeros.astype(np.int32)}


def test_bc_fallback_steps_equal_the_jax_package(tmp_path):
    from sheeprl_tpu.flywheel.recipe import build_finetune_step as jbuild
    from sheeprl_tpu_torch.flywheel.recipe import build_finetune_step

    jcore, tcore = _linear_cores()
    fw = {"flywheel": {"lr": 0.2}}
    jstep, tstep = jbuild("bc_linear", JConfig(fw), core=jcore), build_finetune_step("bc_linear", Config(fw), core=tcore)
    rng = np.random.default_rng(0)
    jparams = {"w": np.zeros((1,), np.float32)}
    tparams = {"w": np.zeros((1,), np.float32)}
    for _ in range(50):
        batch = _bc_batch(rng)
        jparams, jm = jstep(jparams, batch, None)
        tparams, tm = tstep(tparams, batch, None)
        assert tm["loss"] == pytest.approx(jm["loss"], rel=REL)
        np.testing.assert_allclose(tparams["w"].numpy(), np.asarray(jparams["w"]), rtol=REL)
    assert tm["device"] == "cpu" and tm["first_loss"] > tm["loss"]
    # the turn: captured obs x=1 with action 2 pull w from 0 toward 2
    w = tfw.CaptureWriter(str(tmp_path / "capture" / "replica_000" / "capture.jsonl"))
    for i in range(16):
        w.record(f"s{i % 2}", {"x": [[1.0]]}, [[2.0]], 0, trace_id=f"t{i}")
    w.close()
    ckpt = tfw.write_checkpoint(tmp_path / "checkpoint", 0, {"params": {"w": np.zeros((1,), np.float32)},
                                                            "algo": "bc_linear"})
    cfg = Config({"flywheel": {"steps": 50, "batch_size": 8, "lr": 0.2, "max_version_lag": 4, "buffer_size": 100,
                               "capture_dir": str(tmp_path / "capture")}})
    out = tfw.run_flywheel(tmp_path, ckpt, cfg=cfg, core=tcore)
    assert out["finetune"]["loss"] < 1.0 < out["finetune"]["first_loss"]
    new = torch.load(out["checkpoint"], weights_only=False)
    assert 1.0 < float(new["params"]["w"][0]) <= 2.5 and not new["params"]["w"].is_cuda


def test_unknown_algo_fails_before_the_ledger_consumes_anything(tmp_path):
    _jax_capture(tmp_path / "capture", torn=False)
    ckpt = tfw.write_checkpoint(tmp_path / "checkpoint", 0, {"params": {"w": np.zeros((1,), np.float32)},
                                                            "algo": "nope"})
    cfg = Config({"flywheel": {"steps": 2, "batch_size": 4, "lr": 0.1, "max_version_lag": 100, "buffer_size": 100,
                               "capture_dir": str(tmp_path / "capture")}})
    with pytest.raises(ValueError, match="No finetune builder"):
        tfw.run_flywheel(tmp_path, ckpt, cfg=cfg)
    assert not (tmp_path / "capture" / "ingest_ledger.json").exists()
    cfg.set_path("flywheel.algo", "synthetic_counter")
    out = tfw.run_flywheel(tmp_path, ckpt, cfg=cfg)
    assert out["ingest"]["samples"] == 45 and out["ingest"]["duplicates"] == 0  # (2 + 3 sessions) x 9


def test_flywheel_checkpoint_loads_through_the_port_reloader(tmp_path):
    from sheeprl_tpu_torch.gateway.replica import _build_replica_server, synthetic_counter_core
    from sheeprl_tpu_torch.serve import CheckpointReloader, InferencePolicy
    from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager

    ckpt_dir = tmp_path / "checkpoint"
    tfw.write_checkpoint(ckpt_dir, 3, {"params": {"w": np.full(1, 7.0, np.float32)}})
    assert not list(ckpt_dir.glob("*.tmp"))  # the atomic write left no tmp file
    assert float(CheckpointManager.load_for_inference(ckpt_dir / "ckpt_3.ckpt")["params"]["w"][0]) == 7.0
    policy = InferencePolicy(synthetic_counter_core("cpu"), {"w": np.zeros((1,), np.float32)}, buckets=[1])
    reloader = CheckpointReloader(policy, ckpt_dir, loaded_step=-1)
    assert reloader.poll_once() and policy.params_version == 1
    assert float(policy.current_params()[0]["counter"]["w"][0]) == 7.0
    # a synthetic replica seeds from its newest checkpoint, and watches the
    # dir only while hot reload is on
    spec = {"mode": "synthetic", "platform": "cpu", "ckpt_dir": str(ckpt_dir), "buckets": [1, 2]}
    pinned = _build_replica_server(dict(spec, hot_reload={"enabled": False}))
    try:
        assert pinned.reloader is None
        assert float(pinned.policy.current_params()[0]["counter"]["w"][0]) == 7.0
    finally:
        pinned.stop()
    watching = _build_replica_server(dict(spec, hot_reload={"enabled": True}))
    try:
        assert watching.reloader is not None and watching.reloader.loaded_step == 3
    finally:
        watching.stop()


def test_cli_flywheel_composes_config_and_takes_a_turn(tmp_path, monkeypatch, capsys):
    from sheeprl_tpu_torch import cli

    _jax_capture(tmp_path / "capture", torn=False)
    ckpt = tfw.write_checkpoint(tmp_path / "checkpoint", 0, {"params": {"w": np.zeros((1,), np.float32)}})
    argv = [f"run_dir={tmp_path}", f"checkpoint_path={ckpt}", "flywheel.algo=synthetic_counter",
            "flywheel.steps=7", "flywheel.max_version_lag=100"]
    run_dir, ckpt_path, cfg = cli.flywheel_config(argv)
    assert run_dir == tmp_path and ckpt_path == pathlib.Path(ckpt)
    assert cfg.select("flywheel.steps") == 7 and cfg.select("flywheel.batch_size") == 64  # composed defaults
    with pytest.raises(ValueError, match="run_dir"):
        cli.flywheel([f"checkpoint_path={ckpt}"])
    cli.flywheel(argv)
    assert "[flywheel]" in capsys.readouterr().out
    assert (tmp_path / "checkpoint" / "ckpt_7.ckpt").is_file()
    assert cli.COMMANDS["flywheel"] is cli.flywheel


def test_cluster_refuses_capture_enabled_with_no_directory():
    from sheeprl_tpu_torch.gateway.cluster import build_cluster

    cfg = Config({"gateway": load_config_file(GATEWAY_YAML).to_dict()})
    cfg.set_path("serve.capture.enabled", True)  # dir null, no telemetry_dir
    with pytest.raises(ValueError, match="no capture directory"):
        build_cluster(cfg, start=False, telemetry_dir=None)


# -- the miniature loop --------------------------------------------------------


def _drive(gw, expected, rounds, mismatches, versions):
    from sheeprl_tpu_torch.telemetry.tracing import make_traceparent, new_span_id, new_trace_id

    for _ in range(rounds):
        for sid in list(expected):
            status, body, _ = gw.handle_act({"obs": {"x": [[0.0]]}, "session_id": sid, "reward": 1.0,
                                             "traceparent": make_traceparent(new_trace_id(), new_span_id())})
            if status != 200:
                continue
            action = float(body["actions"][0][0])
            if action != float(expected[sid]):
                mismatches.append((sid, expected[sid], action))
            expected[sid] = int(action) + 1
            versions.append(int(body.get("params_version") or 0))


def test_flywheel_miniature_loop_e2e(tmp_path):
    from sheeprl_tpu_torch.gateway.cluster import build_cluster
    from sheeprl_tpu_torch.serve.reload import _list_checkpoints
    from sheeprl_tpu_torch.telemetry.sinks import JsonlSink

    ckpt_dir = tmp_path / "checkpoint"
    seed = tfw.write_checkpoint(ckpt_dir, 0, {"params": {"w": np.zeros((1,), np.float32)}})
    capture_root = tmp_path / "capture"
    cfg = Config({"gateway": load_config_file(GATEWAY_YAML).to_dict()})
    for key, val in {"gateway.replicas": 2, "gateway.http.port": 0, "gateway.replica.platform": "cpu",
                     "gateway.supervisor.health_poll_s": 0.1, "gateway.replica.ckpt_dir": str(ckpt_dir),
                     "gateway.replica.hot_reload.poll_interval_s": 3600.0, "serve.capture.enabled": True,
                     "serve.capture.dir": str(capture_root), "serve.capture.sample_frac": 1.0}.items():
        cfg.set_path(key, val)
    sink = JsonlSink(str(tmp_path / "telemetry.jsonl"))
    gw = build_cluster(cfg, sink=sink, start=True, telemetry_dir=tmp_path)
    manager = gw.manager
    mismatches: list = []
    versions: list = []
    try:
        assert len(manager.routable()) == 2
        expected = {f"s{i:02d}": 0 for i in range(12)}
        _drive(gw, expected, rounds=4, mismatches=mismatches, versions=versions)
        assert mismatches == [] and set(versions) == {0}
        fw_cfg = Config({"flywheel": {"steps": 3, "batch_size": 8, "lr": 0.5, "max_version_lag": 4,
                                      "buffer_size": 1000, "algo": "synthetic_counter",
                                      "capture_dir": str(capture_root)}})
        out = tfw.run_flywheel(tmp_path, seed, cfg=fw_cfg, emit=sink.write,
                               rolling_reload=lambda: manager.rolling_reload(settle_timeout_s=30.0))
        assert out["ingest"]["samples"] == 48 and out["ingest"]["trace_join_frac"] == 1.0
        assert out["checkpoint"].endswith("ckpt_3.ckpt")
        assert all(r.get("swapped") for r in out["reload"]["results"]), out["reload"]
        versions_after: list = []
        _drive(gw, expected, rounds=2, mismatches=mismatches, versions=versions_after)
        assert mismatches == [] and set(versions_after) == {1}
        assert all(v >= 6 for v in expected.values())
        again = tfw.ingest(capture_root, ReplayBuffer(100, n_envs=1),
                           ledger=tfw.IngestLedger(capture_root / "ingest_ledger.json"))
        assert again["samples"] == 24 and again["duplicates"] == 48
        third = tfw.ingest(capture_root, ReplayBuffer(10, n_envs=1),
                           ledger=tfw.IngestLedger(capture_root / "ingest_ledger.json"))
        assert third["samples"] == 0 and third["duplicates"] == 72
    finally:
        gw.stop()
        manager.shutdown()
        sink.close()
    assert [s for s, _ in _list_checkpoints(ckpt_dir)] == [0, 3]
