"""The serving stack of the PyTorch port (``sheeprl_tpu_torch/serve/``) on the CPU.

* Policy parity: ``InferencePolicy`` for ``ppo`` (discrete and continuous),
  ``sac`` and ``dreamer_v3`` at narrow widths, with the JAX package's
  parameters converted, against the JAX package's ``InferencePolicy`` on the
  same observations; the stochastic actions use the noise the JAX policy's
  key schedule draws (``split(key)`` per batch, ``split(key, 3)`` for
  DreamerV3), handed to the port's ``draw_noise``. Tolerance atol 1e-5
  (continuous actions and DreamerV3's latents, carried over 8 steps);
  discrete actions exactly.
* The serving logic of ``tests/test_serve.py``, ported: mixed batches with
  no shape warmup did not run, oversized batches chunked at the largest
  bucket, malformed observations rejected before batching, LRU eviction
  and expiry of a session, coalescing, backpressure with ``Retry-After``,
  grouping by the ``deterministic`` flag, errors passed to the caller, the
  reloader skipping older and corrupt checkpoints, a hot reload that drops
  no request while a batch launched before the swap keeps the old weights,
  ``load_for_inference`` leaving out the optimizer and the buffer, ``cli
  serve`` composing the serve config, and session blobs crossing between
  the packages both ways.
* HTTP: ``/v1/act``, ``/healthz``, ``/stats`` (the JAX package's ``serve``
  record's keys), ``/metrics``, 410 and 503, the serve stream passing both
  packages' validators, and the ``serve`` command answering ``/v1/act`` from
  a subprocess.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.config import compose as torch_compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.serve import (Backpressure, CheckpointReloader, InferencePolicy, MicroBatcher, PolicyCore,
                                     PolicyServer, SessionExpired)
from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
PPO_ARGS = ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "algo.rollout_steps=8",
            "algo.per_rank_batch_size=4", "algo.update_epochs=1", "algo.mlp_keys.encoder=[state]",
            "algo.cnn_keys.encoder=[]", "algo.dense_units=8", "algo.mlp_layers=1", "algo.total_steps=32",
            "algo.run_test=False", "buffer.memmap=False", "metric.log_level=0", "checkpoint.every=16"]
DV3_ARGS = ["exp=dreamer_v3", "env=dummy", "env.id=discrete_dummy", "algo=dreamer_v3_XS", "algo.dense_units=16",
            "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=16",
            "algo.world_model.recurrent_model.dense_units=16", "algo.world_model.transition_model.hidden_size=16",
            "algo.world_model.representation_model.hidden_size=16", "algo.world_model.discrete_size=4",
            "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"]
OBS = {"state": spaces.Box(-20, 20, (10,), np.float32)}
JOBS = {"state": gym.spaces.Box(-20, 20, (10,), np.float32)}


@pytest.fixture(scope="module")
def ppo_ckpt(tmp_path_factory):
    """One tiny PPO checkpoint of the port for the whole module (32 CPU steps)."""
    from sheeprl_tpu_torch import cli

    root = tmp_path_factory.mktemp("serve_ppo")
    old = os.getcwd()
    os.chdir(root)
    try:
        cli.run(PPO_ARGS + ["fabric.accelerator=cpu"])
        ckpts = sorted(glob.glob("logs/runs/ppo/discrete_dummy/*/version_*/checkpoint/ckpt_*.ckpt"),
                       key=lambda p: int(Path(p).stem.split("_")[1]))
        assert ckpts, "training produced no checkpoint"
        return (root / ckpts[-1]).resolve()
    finally:
        os.chdir(old)


def _obs(n: int) -> dict:
    return {"state": np.full((n, 10), 3.0, np.float32)}


def _cfgs(args):
    from sheeprl_tpu.config import compose

    return compose("config", args), torch_compose("config", args + ["fabric.accelerator=cpu"])


class _JaxDraws:
    """The JAX policy's key schedule, replayed: every batch splits the
    policy's key once (``split(key, parts)``) and draws its noise from the
    sub-keys, exactly as the JAX builders' ``apply`` does."""

    def __init__(self, seed, parts, draw):
        self.key, self.parts, self.draw = jax.random.key(int(seed)), parts, draw

    def __call__(self, generator, n):
        keys = jax.random.split(self.key, self.parts)
        self.key = keys[0]
        return self.draw(keys[1:], n)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- policy parity with the JAX package ---------------------------------------


def _ppo_pair(env_id):
    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build
    from sheeprl_tpu.parallel import Distributed
    from sheeprl_tpu.serve import InferencePolicy as JaxPolicy
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent

    args = [a for a in PPO_ARGS if not a.startswith("env.id")] + [f"env.id={env_id}"]
    jcfg, tcfg = _cfgs(args)
    cont = env_id == "continuous_dummy"
    jact = gym.spaces.Box(-1, 1, (2,), np.float32) if cont else gym.spaces.Discrete(4)
    tact = spaces.Box(-1, 1, (2,), np.float32) if cont else spaces.Discrete(4)
    _, jparams = jax_build(Distributed(devices=1), jcfg, gym.spaces.Dict(JOBS), jact, jax.random.PRNGKey(3))
    agent = build_agent(tcfg, spaces.Dict(OBS), tact, torch.device("cpu"))
    convert.load_ppo(jax.tree.map(np.asarray, jparams), agent)
    jpol = JaxPolicy.from_state(jcfg, jparams, gym.spaces.Dict(JOBS), jact, buckets=[1, 2, 4])
    tpol = InferencePolicy.from_state(tcfg, {"agent": agent.state_dict()}, spaces.Dict(OBS), tact, buckets=[1, 2, 4])
    if cont:
        draw = _JaxDraws(tcfg.seed, 2, lambda k, n: [_t(jax.random.normal(k[0], (n, 2)))])
    else:
        draw = _JaxDraws(tcfg.seed, 2, lambda k, n: [_t(jax.random.gumbel(jax.random.split(k[0], 1)[0], (n, 4)))])
    return jpol, tpol, draw, cont


def _sac_pair():
    from sheeprl_tpu.algos.sac.agent import SACActor
    from sheeprl_tpu.serve import InferencePolicy as JaxPolicy
    from sheeprl_tpu_torch.algos.sac.agent import build_actor

    args = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "algo.hidden_size=8"]
    jcfg, tcfg = _cfgs(args)
    low, high = np.array([-1.0, -2.0], np.float32), np.array([1.0, 0.5], np.float32)
    jact, tact = gym.spaces.Box(low, high, (2,), np.float32), spaces.Box(low, high, (2,), np.float32)
    jactor = SACActor(action_dim=2, hidden_size=8, action_low=low.tolist(), action_high=high.tolist())
    jparams = jactor.init(jax.random.PRNGKey(1), np.zeros((1, 10), np.float32))["params"]
    actor = build_actor(tcfg, 10, tact, 8)
    sd = convert.params_to_state_dict(jax.tree.map(np.asarray, jparams), actor)
    jpol = JaxPolicy.from_state(jcfg, {"actor": jparams}, gym.spaces.Dict(JOBS), jact, buckets=[1, 2, 4])
    tpol = InferencePolicy.from_state(tcfg, {"agent": {f"actor.{k}": v for k, v in sd.items()}}, spaces.Dict(OBS),
                                      tact, buckets=[1, 2, 4])
    draw = _JaxDraws(tcfg.seed, 2, lambda k, n: _t(jax.random.normal(k[0], (n, 2))))
    return jpol, tpol, draw, True


@pytest.mark.parametrize("case", ["ppo-discrete", "ppo-continuous", "sac"])
def test_policy_parity_with_jax(case):
    jpol, tpol, draw, cont = (_sac_pair() if case == "sac" else
                              _ppo_pair("continuous_dummy" if case.endswith("continuous") else "discrete_dummy"))
    tpol.core.draw_noise = draw
    rng = np.random.default_rng(4)
    for i, greedy in enumerate([True, False, False, True, False]):
        n = (3, 3, 4, 4, 3)[i]  # padded and full buckets, greedy and sampled
        obs = {"state": rng.standard_normal((n, 10)).astype(np.float32)}
        want = np.asarray(jpol.act_batch(jpol.prepare(obs, n), n, deterministic=greedy))
        got = tpol.act_batch(tpol.prepare(obs, n), n, deterministic=greedy)
        assert got.shape == want.shape
        if cont:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(got, want)


def test_dreamer_v3_policy_parity_over_8_steps():
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build
    from sheeprl_tpu.parallel import Distributed
    from sheeprl_tpu.serve import InferencePolicy as JaxPolicy
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent

    jcfg, tcfg = _cfgs(DV3_ARGS)
    _, _, _, params = jax_build(Distributed(devices=1), jcfg, gym.spaces.Dict(JOBS), [4], False, jax.random.key(0))
    jstate = {"wm": params["wm"], "actor": params["actor"]}
    wm, actor, _, _ = build_agent(tcfg, spaces.Dict(OBS), [4], False, torch.device("cpu"))
    tstate = {k: convert.params_to_state_dict(jax.tree.map(np.asarray, jstate[k]), m)
              for k, m in (("wm", wm), ("actor", actor))}
    jpol = JaxPolicy.from_state(jcfg, jstate, gym.spaces.Dict(JOBS), gym.spaces.Discrete(4), buckets=[1, 2, 4])
    tpol = InferencePolicy.from_state(tcfg, tstate, spaces.Dict(OBS), spaces.Discrete(4), buckets=[1, 2, 4])
    S, D = 4, 4

    def dv3(k, n):
        return {"repr": _t(jax.random.gumbel(k[0], (n, S, D))),
                "act": [_t(jax.random.gumbel(jax.random.split(k[1], 1)[0], (n, 4)))]}

    tpol.core.draw_noise = _JaxDraws(tcfg.seed, 3, dv3)
    assert tpol.core.stateful and tpol.core.tol == 1e-4
    for a, b in zip(tpol._init_row, jpol._init_row):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)
    rng = np.random.default_rng(5)
    sessions = ["a", "b", "c"]
    for step in range(8):
        greedy = step % 3 == 0
        obs = {"state": rng.standard_normal((3, 10)).astype(np.float32)}
        want = np.asarray(jpol.act_batch(jpol.prepare(obs, 3), 3, greedy, sessions=sessions))
        got = tpol.act_batch(tpol.prepare(obs, 3), 3, greedy, sessions=sessions)
        np.testing.assert_array_equal(got, want)
        for sid in sessions:
            for a, b in zip(tpol.sessions.get(sid), jpol.sessions.get(sid)):
                np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)


# -- InferencePolicy -----------------------------------------------------------


def test_policy_from_checkpoint_serves_mixed_batches_without_shape_misses(ppo_ckpt):
    policy = InferencePolicy.from_checkpoint(ppo_ckpt, buckets=[1, 2, 4, 8])
    assert policy.device == torch.device("cpu")
    assert policy.warmup() == 8  # 4 buckets x 2 greedy variants
    for n in (1, 2, 3, 5, 8):
        actions = policy.act_batch(policy.prepare(_obs(n), n), n, deterministic=True)
        assert actions.shape == (n, 1) and set(actions.ravel().tolist()) <= {0, 1, 2, 3}
    policy.act_batch(policy.prepare(_obs(3), 3), 3, deterministic=False)
    assert policy.retraces_since_warmup() == 0
    # a pair warmup did not run is counted, once
    cold = InferencePolicy.from_checkpoint(ppo_ckpt, buckets=[1, 2])
    cold.warmup((True,))
    cold.act(_obs(1), deterministic=False)
    cold.act(_obs(1), deterministic=False)
    assert cold.retraces_since_warmup() == 1


def test_policy_oversized_batch_chunks_to_max_bucket(ppo_ckpt):
    policy = InferencePolicy.from_checkpoint(ppo_ckpt, buckets=[1, 2, 4])
    policy.warmup((True,))
    actions = policy.act_batch(policy.prepare(_obs(11), 11), 11, deterministic=True)
    assert actions.shape == (11, 1)
    assert policy.retraces_since_warmup() == 0
    # a deterministic row is the same whatever batch it rides in
    np.testing.assert_array_equal(actions[:1], policy.act(_obs(1), deterministic=True))


def test_malformed_obs_rejected_before_batching(ppo_ckpt):
    policy = InferencePolicy.from_checkpoint(ppo_ckpt, buckets=[1, 2])
    policy.warmup((True,))
    batcher = MicroBatcher(policy, max_wait_ms=0.0).start()
    try:
        with pytest.raises(ValueError, match="shape"):
            batcher.submit({"state": np.zeros((5,), np.float32)}, deterministic=True)
        with pytest.raises(ValueError, match="structure"):
            policy.validate_prepared({"state": np.zeros((1, 10), np.float32), "rgb": np.zeros(1)}, 1)
        assert batcher.submit(_obs(1), deterministic=True).shape == (1, 1)
    finally:
        batcher.stop()
    assert policy.retraces_since_warmup() == 0 and batcher.stats.snapshot()["errors"] == 0


def test_load_for_inference_skips_optimizer_and_buffer(ppo_ckpt):
    full = CheckpointManager.load(ppo_ckpt)
    lean = CheckpointManager.load_for_inference(ppo_ckpt)
    assert {"opt_state", "opt_states"} & set(full), "PPO checkpoints carry optimizer state"
    assert not {"opt_state", "opt_states", "rb"} & set(lean)
    assert "agent" in lean and "policy_step" in lean


def test_cli_serve_composes_serve_config(ppo_ckpt, monkeypatch):
    from sheeprl_tpu_torch import cli

    captured = {}
    monkeypatch.setattr("sheeprl_tpu_torch.serve.server.serve_from_checkpoint",
                        lambda ckpt, cfg, block=True: captured.update(ckpt=ckpt, cfg=cfg))
    cli.serve([f"checkpoint_path={ppo_ckpt}", "serve.http.port=0", "serve.max_wait_ms=1.5"])
    cfg = captured["cfg"]
    assert list(cfg.select("serve.buckets")) == [1, 2, 4, 8, 16]
    assert cfg.select("serve.http.port") == 0 and cfg.select("serve.max_wait_ms") == 1.5
    assert cfg.select("algo.name") == "ppo"  # the run's config underneath
    assert cli.COMMANDS["serve"] is cli.serve
    with pytest.raises(ValueError, match="Malformed override"):
        cli.serve([f"checkpoint_path={ppo_ckpt}", "serve.http.port"])
    with pytest.raises(ValueError, match="checkpoint_path"):
        cli.serve([])


def test_capture_is_refused_until_the_flywheel(ppo_ckpt, tmp_path):
    """The flywheel is ported: ``serve.capture.enabled=True`` no longer
    raises, it writes capture segments — one record per acked act of a
    session, none for a sessionless act, valid for both packages — and the
    ``capture_*`` gauges reach ``/metrics``."""
    from sheeprl_tpu.telemetry.schema import validate_jsonl as jax_validate
    from sheeprl_tpu_torch.config import load_config_file
    from sheeprl_tpu_torch.serve import serve_from_checkpoint
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    cfg = load_config_file(ppo_ckpt.parent.parent / "config.yaml")
    cfg["serve"] = load_config_file(REPO / "sheeprl_tpu_torch" / "configs" / "serve" / "default.yaml")
    for key, val in {"serve.http.port": 0, "serve.hot_reload.enabled": False, "serve.telemetry.jsonl": False,
                     "serve.capture.enabled": True, "serve.capture.dir": str(tmp_path / "capture")}.items():
        cfg.set_path(key, val)
    server = serve_from_checkpoint(ppo_ckpt, cfg, block=False)
    try:
        for step in range(3):
            code, _, _ = _http(server.port, "/v1/act", {"obs": {"state": [float(step)] * 10}, "session_id": "u1",
                                                        "deterministic": True, "reward": 0.5})
            assert code == 200
        assert _http(server.port, "/v1/act", {"obs": {"state": [0.0] * 10}})[0] == 200
        code, body, _ = _http(server.port, "/metrics")
        assert "sheeprl_serve_capture_captured 3" in body and "sheeprl_serve_capture_skipped 1" in body
    finally:
        server.stop()
    segment = tmp_path / "capture" / "replica_000" / "capture.jsonl"
    recs = [json.loads(line) for line in open(segment)]
    assert [(r["session_id"], r["step"], r["params_version"]) for r in recs] == [("u1", i, 0) for i in range(3)]
    assert recs[1]["obs"] == {"state": [1.0] * 10} and recs[1]["reward"] == 0.5
    assert validate_jsonl(str(segment)) == [] and jax_validate(str(segment)) == []


# -- sessions ------------------------------------------------------------------


def _counter_core(block=None) -> PolicyCore:
    """Stateful fake: the state counts each session's steps and the action
    echoes the pre-step counter plus the parameter ``w``, so session
    isolation and the weights a batch used are both observable. ``block``
    (an event pair) parks ``apply`` once, after it took its parameters."""
    def apply(params, obs, state, noise, greedy):
        if block is not None and not block[0].is_set():
            block[0].set()
            assert block[1].wait(10.0)
        (count,) = state
        return count + params["m"]["w"], (count + 1.0,)

    return PolicyCore(apply=apply, extract_params=lambda p: p,
                      prepare=lambda raw, n: np.asarray(raw["x"], np.float32).reshape(n, -1),
                      dummy_obs=lambda n: np.zeros((n, 1), np.float32), draw_noise=lambda g, n: None,
                      device=torch.device("cpu"), init_state=lambda params, n: (torch.zeros(n, 1),), name="counter")


W0 = {"m": {"w": np.zeros((1,), np.float32)}}


def test_sessions_carry_state_evict_least_recently_used_and_expire():
    policy = InferencePolicy(_counter_core(), W0, buckets=[1, 2, 4])
    policy.warmup((True,))
    obs = {"x": [0.0]}
    assert [float(policy.act(obs, True, session=s)[0, 0]) for s in "aab"] == [0.0, 1.0, 0.0]
    assert float(policy.act(obs, True, session=None)[0, 0]) == 0.0  # sessionless: fresh, not stored
    # three sessions stepped together with padding, then a in another mix
    obs3 = policy.prepare({"x": [[0.0], [0.0], [0.0]]}, 3)
    np.testing.assert_allclose(policy.act_batch(obs3, 3, True, sessions=["a", "b", "c"]), [[2.0], [1.0], [0.0]])
    np.testing.assert_allclose(policy.act_batch(policy.prepare(obs, 1), 1, True, sessions=["a"]), [[3.0]])
    assert policy.retraces_since_warmup() == 0
    # LRU (recency b, c, a): with room for two, stepping c evicts b, and
    # stepping b again (a fresh start outside the batcher) evicts a
    policy.sessions.max_sessions = 2
    evicted = []
    batcher = MicroBatcher(policy, max_wait_ms=0.0).start()
    try:
        policy.act(obs, True, session="c")
        policy.act(obs, True, session="b")
        assert policy.sessions.get("a") is None and len(policy.sessions) == 2
        assert policy.session_expired("a") and batcher.stats.snapshot()["evictions"] == 2
        with pytest.raises(SessionExpired):
            batcher.submit(obs, True, session="a")
        assert batcher.stats.snapshot()["expired"] == 1
        # re-hydrating the session (the broker copy) clears its tombstone
        policy.import_session("a", (np.full((1, 1), 7.0, np.float32),))
        assert not policy.session_expired("a")
        assert float(batcher.submit(obs, True, session="a")[0, 0]) == 7.0
        evicted.append(policy.export_session("a"))
    finally:
        batcher.stop()
    np.testing.assert_array_equal(evicted[0][0], [[8.0]])


def test_session_blobs_cross_between_the_packages():
    from sheeprl_tpu.serve.session_codec import decode_state as jax_decode
    from sheeprl_tpu.serve.session_codec import encode_state as jax_encode
    from sheeprl_tpu_torch.serve.session_codec import StateDecodeError, decode_state, encode_state

    row = (np.arange(4, dtype=np.float32).reshape(1, 4), np.ones((1, 2, 3), np.float32), np.zeros((1, 5)))
    for enc, dec in ((jax_encode, decode_state), (encode_state, jax_decode)):
        back = dec(enc(row))
        assert isinstance(back, tuple) and all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(back, row))
    import base64
    import pickle
    import zlib

    evil = base64.b64encode(zlib.compress(pickle.dumps(os.system))).decode()
    with pytest.raises(StateDecodeError):
        decode_state(evil)


# -- micro-batching ------------------------------------------------------------


def test_batcher_coalesces_concurrent_requests(ppo_ckpt):
    policy = InferencePolicy.from_checkpoint(ppo_ckpt, buckets=[1, 2, 4, 8])
    policy.warmup((True, False))
    batcher = MicroBatcher(policy, max_wait_ms=100.0, max_pending=64).start()
    results: dict = {}

    def client(i: int):
        results[i] = batcher.submit(_obs(1), deterministic=True)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    batcher.stop()
    assert len(results) == 24 and all(r.shape == (1, 1) for r in results.values())
    snap = batcher.stats.snapshot()
    assert snap["completed"] == 24 and snap["batches"] < 24 and snap["avg_batch_size"] > 1.0
    assert 0.0 < snap["batch_occupancy"] <= 1.0 and snap["pad_waste"] == pytest.approx(1 - snap["batch_occupancy"])
    assert policy.retraces_since_warmup() == 0


class _BlockingPolicy:
    """Minimal InferencePolicy stand-in whose act_batch blocks on an event."""

    def __init__(self):
        self.buckets = [1, 2, 4]
        self.entered = threading.Event()
        self.release = threading.Event()
        self.sessions = {}
        self.reload_count = 0
        self.params_version = 0

    def prepare(self, raw, n):
        return {"x": np.zeros((n, 1), np.float32)}

    def act_batch(self, obs, n, deterministic=False, sessions=None, expired_out=None):
        self.entered.set()
        assert self.release.wait(30.0)
        return np.zeros((n, 1), np.float32)

    def retraces_since_warmup(self):
        return 0


def _fill_queue(policy, batcher, k):
    threads = [threading.Thread(target=lambda: batcher.submit({"x": [0.0]}), daemon=True)]
    threads[0].start()
    assert policy.entered.wait(10.0)  # the first request is taken and blocks
    more = [threading.Thread(target=lambda: batcher.submit({"x": [0.0]}), daemon=True) for _ in range(k)]
    threads += more
    for t in more:
        t.start()
    deadline = time.monotonic() + 10.0
    while batcher.queue_depth < k and time.monotonic() < deadline:
        time.sleep(0.01)
    assert batcher.queue_depth == k
    return threads


def test_backpressure_rejects_with_retry_after():
    policy = _BlockingPolicy()
    batcher = MicroBatcher(policy, max_wait_ms=0.0, max_pending=3).start()
    threads = []
    try:
        threads = _fill_queue(policy, batcher, 3)
        with pytest.raises(Backpressure) as exc:
            batcher.submit({"x": [0.0]})
        assert exc.value.retry_after_s > 0 and exc.value.depth == 3
        assert batcher.stats.snapshot()["rejected"] == 1
    finally:
        policy.release.set()
        for t in threads:
            t.join(timeout=10.0)
        batcher.stop()


def test_batcher_groups_by_deterministic_flag():
    from sheeprl_tpu_torch.serve.batcher import _Request

    policy = _BlockingPolicy()
    batcher = MicroBatcher(policy, max_wait_ms=200.0, max_pending=64)
    batcher._pending.extend(_Request(policy.prepare({"x": [0.0]}, 1), f, None) for f in [True, True, False, True])
    with batcher._cv:
        first = batcher._take_batch_locked()
        second = batcher._take_batch_locked()
        third = batcher._take_batch_locked()
    assert [r.deterministic for r in first] == [True, True]  # stops at the flip
    assert [r.deterministic for r in second] == [False] and [r.deterministic for r in third] == [True]


def test_batcher_propagates_policy_error_to_caller():
    class _FailingPolicy(_BlockingPolicy):
        def act_batch(self, obs, n, deterministic=False, sessions=None, expired_out=None):
            raise ValueError("bad obs shape")

    batcher = MicroBatcher(_FailingPolicy(), max_wait_ms=0.0).start()
    try:
        with pytest.raises(ValueError, match="bad obs shape"):
            batcher.submit({"x": [0.0]})
    finally:
        batcher.stop()
    snap = batcher.stats.snapshot()
    assert snap["errors"] == 1 and snap["completed"] == 0


# -- hot reload ----------------------------------------------------------------


def _perturbed_state(ckpt_path, delta=1.0):
    state = CheckpointManager.load(ckpt_path)
    state["agent"] = {k: v + delta if v.is_floating_point() else v for k, v in state["agent"].items()}
    return state


def test_hot_reload_swaps_params_without_dropping_requests(ppo_ckpt, tmp_path):
    import shutil

    ckdir = tmp_path / "run" / "checkpoint"
    ckdir.mkdir(parents=True)
    shutil.copy(ppo_ckpt.parent.parent / "config.yaml", tmp_path / "run" / "config.yaml")
    ck = ckdir / ppo_ckpt.name
    shutil.copy(ppo_ckpt, ck)
    policy = InferencePolicy.from_checkpoint(ck, buckets=[1, 2, 4])
    policy.warmup((True,))
    before = {k: v.clone() for k, v in policy.current_params()[0]["agent"].items()}
    step = int(ck.stem.split("_")[1])
    reloader = CheckpointReloader(policy, ckdir, loaded_step=step)
    errors: list = []
    served = [0]
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                policy.act_batch(policy.prepare(_obs(2), 2), 2, deterministic=True)
                served[0] += 1
            except BaseException as e:  # pragma: no cover - failure path
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        CheckpointManager(str(ckdir.parent)).save(step + 1, _perturbed_state(ck))
        assert reloader.poll_once(), "reloader must pick up the newer checkpoint"
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
    assert not errors and served[0] > 0
    assert policy.reload_count == 1 and policy.params_version == 1
    after = policy.current_params()[0]["agent"]
    for k, v in before.items():
        if v.is_floating_point():
            torch.testing.assert_close(after[k], v + 1.0)
            assert after[k].data_ptr() != v.data_ptr()
    policy.act_batch(policy.prepare(_obs(3), 3), 3, deterministic=True)
    assert policy.retraces_since_warmup() == 0


def test_batch_in_flight_keeps_the_old_weights():
    """A batch that took the parameters before a swap finishes with them;
    the swap builds new tensors instead of writing into the ones it reads."""
    block = (threading.Event(), threading.Event())
    policy = InferencePolicy(_counter_core(block), W0, buckets=[1])
    old_w = policy.current_params()[0]["m"]["w"]
    out = {}
    t = threading.Thread(target=lambda: out.update(a=policy.act({"x": [0.0]}, True, session="s")))
    t.start()
    assert block[0].wait(10.0)  # the batch is inside apply, with the old dict
    # the swap replaces the reference at once; it returns once the batch has
    # let go of the apply (its initial state row is made there)
    swap = threading.Thread(target=policy.swap_params, args=({"m": {"w": np.full((1,), 5.0, np.float32)}},))
    swap.start()
    deadline = time.monotonic() + 10.0
    while policy.params_version != 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert policy.current_params()[1] == 1 and float(policy.current_params()[0]["m"]["w"][0]) == 5.0
    block[1].set()
    t.join(10.0)
    swap.join(10.0)
    assert float(out["a"][0, 0]) == 0.0 and float(old_w[0]) == 0.0
    assert float(policy.act({"x": [0.0]}, True, session="s")[0, 0]) == 6.0  # new weights, state kept


def test_reloader_ignores_older_and_corrupt_checkpoints(ppo_ckpt):
    from sheeprl_tpu_torch.serve.reload import _list_checkpoints

    policy = InferencePolicy.from_checkpoint(ppo_ckpt, buckets=[1])
    events = []

    class _Sink:
        def write(self, rec):
            events.append(rec)

    step = _list_checkpoints(ppo_ckpt.parent)[-1][0]
    reloader = CheckpointReloader(policy, ppo_ckpt.parent, loaded_step=step, sink=_Sink())
    assert not reloader.poll_once()  # nothing newer
    older = CheckpointReloader(policy, ppo_ckpt.parent, loaded_step=step + 100)
    assert not older.poll_once()  # everything is older than what it serves
    bad = ppo_ckpt.parent / f"ckpt_{step + 5}.ckpt"
    bad.write_bytes(b"not a checkpoint")
    try:
        assert not reloader.poll_once()  # corrupt file reported, not fatal
        assert policy.reload_count == 0 and reloader.loaded_step == step + 5  # and not retried forever
        assert events[-1]["event"] == "reload" and events[-1]["action"] == "failed"
    finally:
        bad.unlink()


# -- HTTP ----------------------------------------------------------------------


def _http(port, path, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def test_http_round_trip(ppo_ckpt):
    from sheeprl_tpu.serve.batcher import MicroBatcher as JaxBatcher
    from sheeprl_tpu.telemetry.schema import validate_jsonl as jax_validate
    from sheeprl_tpu_torch.config import load_config_file
    from sheeprl_tpu_torch.serve import serve_from_checkpoint
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    cfg = load_config_file(ppo_ckpt.parent.parent / "config.yaml")
    cfg["serve"] = load_config_file(REPO / "sheeprl_tpu_torch" / "configs" / "serve" / "default.yaml")
    cfg.set_path("serve.http.port", 0)
    cfg.set_path("serve.hot_reload.enabled", False)
    server = serve_from_checkpoint(ppo_ckpt, cfg, block=False)
    try:
        port = server.port
        code, body, _ = _http(port, "/v1/act", {"obs": {"state": [3.0] * 10}, "deterministic": True,
                                                "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01"})
        out = json.loads(body)
        assert code == 200 and np.asarray(out["actions"]).shape == (1, 1) and out["params_version"] == 0
        assert out["trace_id"] == "a" * 32 and set(out["timing"]) == {"batch_queue_ms", "jit_step_ms", "export_ms"}
        code, body, _ = _http(port, "/v1/act", {"obs": {"state": [3.0] * 4}})
        assert code == 400 and "shape" in json.loads(body)["error"]
        code, body, _ = _http(port, "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, body, _ = _http(port, "/stats")
        stats = json.loads(body)
        jax_keys = set(JaxBatcher(_BlockingPolicy()).serve_record())
        assert set(stats) == jax_keys and stats["completed"] == 1 and stats["retraces"] == 0
        code, body, headers = _http(port, "/metrics")
        assert code == 200 and "sheeprl_serve_requests_total 1" in body and "sheeprl_serve_latency_ms_bucket" in body
        code, body, _ = _http(port, "/admin/reload", {})
        assert code == 409  # no reloader attached
        code, body, _ = _http(port, "/admin/clock", {"t_send": time.time()})
        assert code == 200 and "offset_s" in json.loads(body)
        assert _http(port, "/nowhere")[0] == 404
    finally:
        server.stop()
    stream = ppo_ckpt.parent.parent / "serve" / "telemetry.jsonl"
    recs = [json.loads(line) for line in open(stream)]
    assert {"serve", "trace_span", "clock"} <= {r["event"] for r in recs}
    assert validate_jsonl(str(stream)) == [] and jax_validate(str(stream)) == []


def test_http_answers_410_for_an_expired_session_and_503_under_backpressure():
    policy = InferencePolicy(_counter_core(), W0, buckets=[1, 2])
    policy.sessions.max_sessions = 1
    server = PolicyServer(policy, MicroBatcher(policy, max_wait_ms=0.0), port=0).start()
    try:
        obs = {"obs": {"x": [0.0]}, "deterministic": True}
        assert _http(server.port, "/v1/act", {**obs, "session_id": "a"})[0] == 200
        code, body, _ = _http(server.port, "/v1/act", {**obs, "session_id": "b", "return_state": True})
        assert code == 200 and "session_state" in json.loads(body)
        code, body, _ = _http(server.port, "/v1/act", {**obs, "session_id": "a"})
        assert code == 410 and json.loads(body) == {"error": "session_expired", "session_id": "a"}
        # a blob from the other session's export re-hydrates a (state in, state out)
        blob = json.loads(_http(server.port, "/v1/act", {**obs, "session_id": "b", "return_state": True})[1])
        code, body, _ = _http(server.port, "/v1/act", {**obs, "session_id": "a", "session_state": blob["session_state"]})
        assert code == 200 and json.loads(body)["actions"] == [[2.0]]
    finally:
        server.stop()
    blocking = _BlockingPolicy()
    batcher = MicroBatcher(blocking, max_wait_ms=0.0, max_pending=1)
    server = PolicyServer(blocking, batcher, port=0).start()
    threads = []
    try:
        threads = _fill_queue(blocking, batcher, 1)
        code, body, headers = _http(server.port, "/v1/act", {"obs": {"x": [0.0]}})
        assert code == 503 and int(headers["Retry-After"]) >= 1 and json.loads(body)["retry_after_s"] > 0
    finally:
        blocking.release.set()
        for t in threads:
            t.join(timeout=10.0)
        server.stop()


def test_serve_command_answers_act_requests(ppo_ckpt):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen([sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={ppo_ckpt}",
                             "fabric.accelerator=cpu", "serve.http.port=0", "serve.telemetry.jsonl=False"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline().strip()
        port = int(re.search(r"listening on http://127.0.0.1:(\d+)$", line).group(1))
        code, body, _ = _http(port, "/v1/act", {"obs": {"state": [1.0] * 10}, "deterministic": True})
        assert code == 200 and np.asarray(json.loads(body)["actions"]).shape == (1, 1)
    finally:
        proc.kill()
        _, err = proc.communicate(timeout=30)
    assert "[serve] policy 'ppo' on cpu" in err
