"""The fleet's batched act service in the PyTorch port
(``sheeprl_tpu_torch/fleet/act_service.py``, ``fleet.act_mode=inference``) on
the CPU.

* The flush loop's batch cut: a head-of-queue run of requests whose rows fit
  the widest bucket, never mixing requests with and without an action mask.
* Rows served by the service — coalesced across workers and padded to a
  bucket — against the same worker's rows acted by the worker-hosted core
  (``act_core``) from the same parameters and noise rows, for SAC and
  DreamerV3: atol 1e-6, not bit for bit (a product's blocking depends on the
  row count; the JAX package's own bitwise claim fails by one ulp on the
  CPU). The DreamerV3 latents live in the service keyed ``"{worker}/{slot}"``;
  a reset mask starts a slot anew, and a re-sent request is answered from
  the idempotency cache without stepping the latents again.
* End to end: ``exp=sac`` with two workers and ``fleet.act_mode=inference``
  (mp and socket transports) ends with the worker mode's ledger (policy
  steps, gradient steps, the Ratio, the buffer's position), its streams pass
  both packages' validators, the service served requests, and no worker
  initialised CUDA.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.fleet.act_core import build_act_core, slot_generators
from sheeprl_tpu_torch.fleet.act_service import ActService, _ActJob

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fleet import COMMON, DV3, SAC  # noqa: E402

ATOL = 1e-6


def _cfg(args):
    return compose("config", args + ["fabric.accelerator=cpu", "fleet.act.max_wait_ms=0.0"])


def _publication(core, seed=0):
    """A publication (module name → state dict of numpy arrays) of freshly
    initialised modules of the core's shapes."""
    torch.manual_seed(seed)
    out = {}
    for name, module in core.modules.items():
        out[name] = {k: (torch.randn_like(v) * 0.3 if v.is_floating_point() else v).numpy().copy()
                     for k, v in module.state_dict().items()}
    return out


def _serve(service, reqs):
    """Submit every request, run one flush of the queue, and return the
    responses by request id."""
    got = {}
    for r in reqs:
        service.submit(r, lambda resp: got.__setitem__(resp["req_id"], resp))
    while True:
        with service._cv:
            batch = service._take_batch_locked()
        if not batch:
            break
        service._run_batch(batch)
    return got


def _req(wid, rid, n, obs, noise, **extra):
    return {"worker_id": wid, "incarnation": 0, "req_id": rid, "n": n, "obs": obs, "noise": noise, **extra}


def _np(tree):
    from sheeprl_tpu_torch.serve.policy import tree_map

    return tree_map(lambda t: t.numpy(), tree)


def test_take_batch_cuts_at_the_widest_bucket_and_at_a_mask_flip():
    service = ActService(_cfg(SAC + ["fleet.act.buckets=[1,2,4]"]), "sac")
    for rid, (n, mask) in enumerate([(2, None), (1, None), (1, None), (1, None), (3, {"m": 1}), (1, None)]):
        service._pending.append(_ActJob({"worker_id": rid, "req_id": rid, "n": n, "mask": mask}, None))
    with service._cv:
        widths = []
        while service._pending:
            widths.append([int(j.req["n"]) for j in service._take_batch_locked()])
    # 2+1+1 fills bucket 4; the next 1 stops at the masked request, which
    # rides alone; the last unmasked request starts a new batch
    assert widths == [[2, 1, 1], [1], [3], [1]]
    assert service._bucket(3) == 4 and service._bucket(5) == 8 and service._bucket(17) == 32


def test_sac_service_rows_match_the_worker_core():
    cfg = _cfg(SAC)
    service = ActService(cfg, "sac").start()
    try:
        params = _publication(service.core)
        service.swap_params(params, 1)
        worker = build_act_core("sac", cfg, *_spaces(cfg))
        worker.extract_params(params)
        rng = np.random.default_rng(0)
        obs = [rng.standard_normal((n, 10)).astype(np.float32) for n in (2, 1)]
        noise = [worker.draw_noise(slot_generators(7 + w, n)) for w, n in enumerate((2, 1))]
        got = _serve(service, [_req(w, 10 + w, len(o), o, _np(z)) for w, (o, z) in enumerate(zip(obs, noise))])
        assert sorted(got) == [10, 11] and all(r["version"] == 1 for r in got.values())
        for w in range(2):
            want, _, _ = worker.act(worker.actor, obs[w], noise[w])
            np.testing.assert_allclose(got[10 + w]["actions"], want.numpy(), atol=ATOL, rtol=0)
        snap = service.snapshot()
        # 3 rows in one bucket of 4: occupancy 0.75, a quarter of padding
        assert snap["act_requests"] == 2 and snap["act_batches"] == 1
        assert snap["act_occupancy"] == 0.75 and snap["act_pad_waste"] == 0.25 and snap["act_version"] == 1
    finally:
        service.stop()


def _spaces(cfg):
    from sheeprl_tpu_torch.utils.env import probe_env_spaces

    s = probe_env_spaces(cfg, 0)
    return s.single_observation_space, s.single_action_space


def _dv3_obs(cfg, rng, n):
    obs = {k: rng.integers(0, 255, (n, 64, 64, 3), dtype=np.uint8) for k in cfg.algo.cnn_keys.encoder}
    obs.update({k: rng.standard_normal((n, 10)).astype(np.float32) for k in cfg.algo.mlp_keys.encoder})
    return obs


def test_dv3_service_sessions_resets_and_idempotent_replay():
    cfg = _cfg(DV3)
    service = ActService(cfg, "dreamer_v3").start()
    try:
        params = _publication(service.core, seed=1)
        service.swap_params(params, 3)
        worker = build_act_core("dreamer_v3", cfg, *_spaces(cfg))
        mods = worker.extract_params(params)
        n = 2
        gens = {w: slot_generators(11 + w, n) for w in range(2)}
        states = {w: worker.init_state(mods, n) for w in range(2)}
        rng = np.random.default_rng(2)
        rid = 0
        for step in range(3):
            obs = {w: _dv3_obs(cfg, rng, n) for w in range(2)}
            noise = {w: worker.draw_noise(gens[w]) for w in range(2)}
            reset = np.array([step == 0, step == 2])  # the first request starts every slot; then slot 1 alone
            reqs = []
            for w in range(2):
                rid += 1
                extra = {"reset": np.ones(n, bool) if step == 0 else reset}
                reqs.append(_req(w, rid, n, obs[w], _np(noise[w]), **extra))
            got = _serve(service, reqs)
            for w, r in zip(range(2), reqs):
                if step == 2:
                    states[w] = worker.reset_state(mods, reset, states[w])
                env_a, cat, states[w] = worker.act(mods, obs[w], noise[w], states[w])
                resp = got[r["req_id"]]
                np.testing.assert_array_equal(resp["actions"], env_a.numpy())
                np.testing.assert_allclose(resp["actions_cat"], cat.numpy(), atol=ATOL, rtol=0)
                for slot in range(n):
                    row = service.sessions.get(f"{w}/{slot}")
                    for x, want in zip(row, states[w]):
                        np.testing.assert_allclose(x, want.numpy()[slot:slot + 1], atol=ATOL, rtol=1e-6)
        assert len(service.sessions) == 4
        # a re-send of the last request is answered from the cache: the same
        # response, and the latents are not stepped again
        rows = {k: service.sessions.get(k) for k in ("0/0", "0/1")}
        last = reqs[0]
        replay = {}
        service.submit(last, lambda resp: replay.update(resp))
        assert replay["req_id"] == last["req_id"]
        np.testing.assert_array_equal(replay["actions_cat"], got[last["req_id"]]["actions_cat"])
        assert service.queue_depth == 0
        for k, row in rows.items():
            assert all(np.array_equal(a, b) for a, b in zip(service.sessions.get(k), row))
        # a duplicate of a request still in flight is dropped (the original answers)
        dup = _req(0, 99, n, obs[0], _np(noise[0]))
        service._inflight.add((0, 0, 99))
        service.submit(dup, lambda resp: pytest.fail("a duplicate in flight must not be answered"))
        assert service.queue_depth == 0
    finally:
        service.stop()


def _ledger(name, extra):
    cli.run(SAC + COMMON + ["algo.total_steps=64", f"run_name={name}", "algo.fleet.workers=2", *extra])
    base = glob.glob(f"logs/runs/sac/*/{name}/version_0")[0]
    ckpt = sorted(glob.glob(f"{base}/checkpoint/*.ckpt"), key=lambda p: int(p.rsplit("_", 1)[1][:-5]))[-1]
    s = torch.load(ckpt, map_location="cpu", weights_only=False)
    return {"policy_step": s["policy_step"], "ratio": s["ratio"], "grad_steps": s["opt_states"]["step"],
            "rb": (s["rb"]["pos"], s["rb"]["full"])}, base


_WORKER_LEDGER = {}


@pytest.mark.parametrize("transport", ["mp", "socket"])
def test_sac_inference_mode_ledger_equals_worker_mode(transport, tmp_path, monkeypatch):
    from sheeprl_tpu.telemetry.schema import validate_jsonl as jax_validate
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    monkeypatch.chdir(tmp_path)
    if "worker" not in _WORKER_LEDGER:
        _WORKER_LEDGER["worker"], _ = _ledger("worker", [])
    led, base = _ledger(f"inference_{transport}", ["fleet.act_mode=inference", f"fleet.transport={transport}"])
    assert led == _WORKER_LEDGER["worker"]
    streams = [f"{base}/telemetry.jsonl"] + sorted(glob.glob(f"{base}/workers/worker_*/telemetry.jsonl"))
    assert len(streams) == 3
    for path in streams:
        assert validate_jsonl(path) == [] and jax_validate(path) == [], path
    events = [json.loads(line) for line in open(streams[0])]
    interval = [e for e in events if e["event"] == "fleet" and e["action"] == "interval"][-1]
    assert interval["act_mode"] == "inference" and interval["act_requests"] > 0 and interval["act_batches"] > 0
    assert any(e["event"] == "trace_span" and e["name"] == "act_infer" for e in events)
    for path in streams[1:]:
        recs = [json.loads(line) for line in open(path)]
        assert any(e["event"] == "trace_span" and e["name"] == "act_submit" for e in recs)
        exit_rec = [e for e in recs if e["event"] == "fleet" and e["action"] == "worker_exit"]
        assert exit_rec and not exit_rec[-1]["cuda_initialized"]
    assert not [t.name for t in threading.enumerate() if t.name.startswith("fleet-")]
