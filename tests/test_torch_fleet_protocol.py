"""The actor fleet's packets, chaos and round merges in the PyTorch port
against the JAX package's own functions on the same inputs (no process is
spawned here):

* a framed packet is byte for byte the JAX package's frame, decodes back,
  and a torn frame raises ``TornPacketError`` (never half-applied);
* the chaos injector tears the same bytes, targets the same workers, gates
  crash and hang on the incarnation and survives the spawn pickle;
* ``apply_concat`` merges a round in worker order and backfills a
  quarantined column from a survivor, ``apply_sliced`` offsets each worker's
  env indices (restarts too), ``_drop_stale`` drops the packets of an older
  publication, ``merge_ppo_round`` backfills and concatenates, and the drain
  counts a trailing partial round: each the same buffer ops, counts and
  arrays as the JAX package's engine (exact: they move numpy arrays only);
* the span and clock records, the relay's bounded and drop-counted
  batches and the on-demand ``torch.profiler`` window.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import pickle
from collections import deque

import numpy as np
import pytest

from sheeprl_tpu.engine import RecordingSink as JaxSink
from sheeprl_tpu.fleet import FleetEngine as JaxEngine
from sheeprl_tpu.fleet import FleetPacket as JaxPacket
from sheeprl_tpu.fleet import FleetRound as JaxRound
from sheeprl_tpu.fleet.programs import merge_ppo_round as jax_merge_ppo_round
from sheeprl_tpu.fleet.protocol import decode_packet as jax_decode
from sheeprl_tpu.fleet.protocol import encode_packet as jax_encode
from sheeprl_tpu.resilience.chaos import ChaosInjector as JaxChaos
from sheeprl_tpu_torch.engine import RecordingSink
from sheeprl_tpu_torch.fleet import FleetEngine, FleetPacket, FleetRound, TornPacketError
from sheeprl_tpu_torch.fleet.engine import host_arrays
from sheeprl_tpu_torch.fleet.programs import merge_ppo_round
from sheeprl_tpu_torch.fleet.protocol import decode_packet, encode_packet
from sheeprl_tpu_torch.resilience.chaos import ChaosInjector


def _rollout(v, t=4, n=1):
    return ({"rewards": np.full((t, n, 1), v, np.float32), "values": np.arange(t * n, dtype=np.float32)
             .reshape(t, n, 1) + v}, np.full((n, 1), v, np.float32), [(v, 4.0)])


@pytest.mark.parametrize("trace", [("", ""), ("a" * 32, "b" * 16)])
def test_frames_are_the_jax_packages_bytes_and_torn_frames_raise(trace):
    payload = _rollout(1.5)
    stats = (("Rewards/rew_avg", 1.5),)
    frame = encode_packet(FleetPacket(1, 2, 7, 4, 3, payload, stats, trace))
    assert frame == jax_encode(JaxPacket(1, 2, 7, 4, 3, payload, stats, trace))
    out, ref = decode_packet(frame), jax_decode(frame)
    assert (out.worker_id, out.incarnation, out.seq, out.env_steps, out.version, out.trace) == \
           (ref.worker_id, ref.incarnation, ref.seq, ref.env_steps, ref.version, ref.trace) == (1, 2, 7, 4, 3, trace)
    np.testing.assert_array_equal(out.payload[0]["values"], payload[0]["values"])

    # a RecordingSink payload round-trips with its ops and deferred stats
    sink = RecordingSink()
    sink.add({"x": np.zeros((1, 2, 3), np.float32)})
    sink.stat("Rewards/rew_avg", 1.5)
    got = decode_packet(encode_packet(FleetPacket(1, 0, 7, 2, 3, sink))).payload
    assert got.ops[0][0] == "add" and got.stats == [("Rewards/rew_avg", 1.5)]

    torn = frame[:-1] + (bytes([frame[-1][0] ^ 0xFF]) + frame[-1][1:],)
    for bad in (torn, ("garbage",)):
        with pytest.raises(TornPacketError):
            decode_packet(bad)


def test_chaos_tears_the_same_bytes_and_gates_like_the_jax_package():
    blob = bytes(range(256)) * 2
    for seed, worker, at in ((11, 0, 3), (5, 1, 2)):
        kw = dict(torn_packet_at=at, torn_workers=[worker], seed=seed)
        port, ref = ChaosInjector(worker, **kw), JaxChaos(worker, **kw)
        assert port.corrupt(blob, at - 1) == blob  # another packet: untouched
        assert port.corrupt(blob, at) == ref.corrupt(blob, at) != blob
        assert pickle.loads(pickle.dumps(port)).corrupt(blob, at) == port.corrupt(blob, at)
        wire = b"SFL1" + blob
        kw = dict(net_corrupt_at=at, net_workers=[worker], seed=seed)
        assert ChaosInjector(worker, **kw).net_corrupt_wire(wire, at) == JaxChaos(worker, **kw).net_corrupt_wire(
            wire, at) != wire
    # targeting: an empty worker list means worker 0
    for w, kw, pub in ((0, dict(crash_at_step=5), None), (1, dict(drop_publication_at=2, drop_workers=[1]), 2),
                       (0, dict(drop_publication_at=2, drop_workers=[1]), 2), (0, {}, None)):
        port, ref = ChaosInjector(w, **kw), JaxChaos(w, **kw)
        assert port.active == ref.active
        if pub is not None:
            assert port.drops_publication(pub) == ref.drops_publication(pub)
    # a respawned incarnation neither re-crashes nor re-hangs without *_repeat
    crash = ChaosInjector(0, crash_at_step=5)
    crash.incarnation = 1
    crash.on_step(10)  # would os._exit on incarnation 0
    hang = ChaosInjector(0, hang_at_step=5, hang_s=0.01)
    hang.incarnation = 1
    hang.on_step(10)
    assert not hang._hung


class _RB:
    def __init__(self):
        self.ops = []

    def add(self, data, idxes=None, validate_args=False):
        self.ops.append(("add", {k: np.array(v) for k, v in data.items()}, idxes))

    def mark_restart(self, i):
        self.ops.append(("restart", int(i), None))


class _Agg:
    def __init__(self):
        self.updates = []

    def update(self, key, value):
        self.updates.append((key, value))


def _same_ops(a, b):
    assert len(a.ops) == len(b.ops)
    for (ka, da, ia), (kb, db, ib) in zip(a.ops, b.ops):
        assert ka == kb and ia == ib
        if ka == "add":
            assert sorted(da) == sorted(db)
            for k in da:
                np.testing.assert_array_equal(da[k], db[k])
        else:
            assert da == db


def _pair(sinks, worker_ids, steps):
    """The same round as the port's and the JAX package's packets."""
    port, ref = [], []
    for wid, (ops, stats) in zip(worker_ids, sinks):
        ps, js = RecordingSink(), JaxSink()
        for data, idx in ops:
            for s in (ps, js):
                if data == "restart":
                    s.mark_restart(idx)
                else:
                    s.add(data, idx)
        for k, v in stats:
            ps.stat(k, v)
            js.stat(k, v)
        port.append(FleetPacket(wid, 0, 0, steps, 1, ps))
        ref.append(JaxPacket(wid, 0, 0, steps, 1, js))
    total = steps * len(worker_ids)
    return FleetRound(port, list(worker_ids), total), JaxRound(ref, list(worker_ids), total)


def _engines(workers, num_envs):
    port, ref = FleetEngine(enabled=True, workers=workers), JaxEngine(enabled=True, workers=workers, telem=None)
    for e in (port, ref):
        e.num_envs, e.envs_per_worker = num_envs, num_envs // workers
    return port, ref


def test_apply_concat_merges_in_worker_order_and_backfills_a_quarantined_column():
    rng = np.random.default_rng(0)
    blocks = {w: {"observations": rng.standard_normal((1, 2, 3)).astype(np.float32),
                  "rewards": rng.standard_normal((1, 2, 1)).astype(np.float32)} for w in range(3)}
    for present in ([0, 1, 2], [0, 2], [1]):  # worker 1, then workers 0 and 2, quarantined
        rnd, jrnd = _pair([([(blocks[w], None)], [("Rewards/rew_avg", float(w))]) for w in present], present, 2)
        port, ref = _engines(3, 6)
        rb, jrb, agg, jagg = _RB(), _RB(), _Agg(), _Agg()
        assert port.apply_concat(rnd, rb, agg) == ref.apply_concat(jrnd, jrb, jagg) == 2 * len(present)
        _same_ops(rb, jrb)
        assert agg.updates == jagg.updates
        merged = rb.ops[0][1]["observations"]
        assert merged.shape == (1, 6, 3)  # full width whatever the round's size
        for w in present:
            np.testing.assert_array_equal(merged[:, 2 * w:2 * w + 2], blocks[w]["observations"])
    with pytest.raises(RuntimeError, match="apply_sliced"):
        rnd, _ = _pair([([(blocks[0], [1])], [])], [0], 2)
        _engines(3, 6)[0].apply_concat(rnd, _RB())


def test_apply_sliced_offsets_each_workers_env_indices():
    ops = [({"x": np.zeros((1, 2, 1), np.float32)}, None), ({"x": np.ones((1, 1, 1), np.float32)}, [1]),
           ("restart", 0)]
    rnd, jrnd = _pair([(ops, [("Game/ep_len_avg", 3.0)]), (ops, [])], [0, 1], 2)
    port, ref = _engines(2, 4)
    rb, jrb, agg, jagg = _RB(), _RB(), _Agg(), _Agg()
    assert port.apply_sliced(rnd, rb, agg) == ref.apply_sliced(jrnd, jrb, jagg) == 4
    _same_ops(rb, jrb)
    assert agg.updates == jagg.updates
    assert [o[2] if o[0] == "add" else o[1] for o in rb.ops] == [[0, 1], [1], 0, [2, 3], [3], 2]


def test_stale_packets_are_dropped_for_strict_rounds():
    """After a crash, a salvaged packet plus the respawned incarnation's
    rollout for the same publication must not leave the worker one
    publication behind: the older one is dropped and counted."""
    port, ref = FleetEngine(enabled=True, workers=2), JaxEngine(enabled=True, workers=2, telem=None)
    for eng, cls in ((port, FleetPacket), (ref, JaxPacket)):
        eng._pending = {0: deque(), 1: deque()}
        stale, fresh = cls(0, 0, 0, 3, 1, None), cls(0, 1, 0, 3, 2, None)
        eng._pending[0].extend([stale, fresh])
        for _ in range(2):  # idempotent: the fresh packet survives
            eng._drop_stale(2, step=0)
        assert [p.version for p in eng._pending[0]] == [2] and eng.dropped_steps == 3


def test_merge_ppo_round_backfills_and_concatenates():
    for present, workers in (([0, 1], 2), ([0, 2], 3), ([1], 3)):
        payloads = {w: _rollout(float(w), n=2) for w in present}
        got = merge_ppo_round(FleetRound([FleetPacket(w, 0, 0, 8, 1, payloads[w]) for w in present], present, 8),
                              workers)
        want = jax_merge_ppo_round(JaxRound([JaxPacket(w, 0, 0, 8, 1, payloads[w]) for w in present], present, 8),
                                   workers)
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and len(got[2]) == len(present)  # backfills don't double-count stats
        assert got[0]["rewards"].shape == (4, 2 * workers, 1)


class _Telem:
    enabled = False

    def __init__(self):
        self.events = []

    def emit(self, rec):
        self.events.append(rec)


class _Sup:
    total_respawns = torn_packets = crashes = hangs = disconnects = 0
    net_stats = None

    def active_ids(self):
        return [0, 1]

    def alive_count(self):
        return 0

    def quarantined_ids(self):
        return []

    def queue_depth_max(self):
        return 0

    def telem_dropped(self):
        return 0

    def drain_telem(self):
        return []

    def shutdown(self, timeout=None):
        return {0: [], 1: []}


def test_shutdown_drain_counts_a_dropped_partial_round():
    out = []
    for eng, sink, cls in ((FleetEngine(enabled=True, workers=2, telem=_Telem()), RecordingSink(), FleetPacket),
                           (JaxEngine(enabled=True, workers=2, telem=_Telem()), JaxSink(), JaxPacket)):
        eng.sup = _Sup()
        sink.add({"x": np.zeros((1, 1, 1), np.float32)})
        eng._pending = {0: deque([cls(0, 0, 0, 3, 1, sink)]), 1: deque()}
        absorbed = []
        assert eng.shutdown(lambda rnd: absorbed.append(rnd) or rnd.env_steps) == 0 and not absorbed
        drain = next(e for e in eng.telem.events if e.get("action") == "drain")
        out.append((drain["drain_dropped"], drain["dropped_steps"], eng.dropped_steps))
    assert out[0] == out[1] == (1, 3, 3)


def test_publications_are_host_arrays():
    import torch

    m = torch.nn.Linear(3, 2)
    arrays = host_arrays({"actor": m})
    assert set(arrays["actor"]) == {"weight", "bias"} and isinstance(arrays["actor"]["weight"], np.ndarray)
    np.testing.assert_array_equal(arrays["actor"]["weight"], m.weight.detach().numpy())
    meta = torch.nn.Linear(3, 2, device="meta")  # any tensor that is not on the host is refused
    with pytest.raises(ValueError, match="not the host"):
        host_arrays({"actor": meta})


def test_tracing_records_relay_and_profiler_match_the_jax_package(tmp_path):
    """The span and clock records validate under both packages' schemas and
    carry the JAX package's fields; the relay drops (and counts) what its
    bounded buffer cannot hold, flushes in size-capped batches and never
    raises; the on-demand profiler writes one Chrome trace per window."""
    import json

    from sheeprl_tpu.telemetry import tracing as jax_tracing
    from sheeprl_tpu.telemetry.relay import RelaySink as JaxRelay
    from sheeprl_tpu.telemetry.schema import validate_event as jax_validate
    from sheeprl_tpu_torch.telemetry import tracing
    from sheeprl_tpu_torch.telemetry.relay import RelaySink, TeeSink
    from sheeprl_tpu_torch.telemetry.schema import validate_event

    ctx = tracing.TraceContext("a" * 32, "b" * 16, "c" * 16)
    span = tracing.span_record("env_step", "worker", ctx, 10.0, 10.25, worker=1, seq=3)
    want = jax_tracing.span_record("env_step", "worker", jax_tracing.TraceContext(*ctx), 10.0, 10.25, worker=1, seq=3)
    assert span == want
    clock = tracing.clock_record(1.0, role="worker", worker=1)
    assert set(clock) == set(jax_tracing.clock_record(1.0, role="worker", worker=1))
    for rec in (span, clock):
        assert validate_event(rec) == [] and jax_validate(rec) == []
    assert tracing.parse_traceparent(tracing.make_traceparent("a" * 32, "b" * 16)) == ("a" * 32, "b" * 16)

    sent = []
    for cls in (RelaySink, JaxRelay):
        relay = cls(lambda b: sent.append(b) or True, role="worker", index=1, max_buffer=3, max_batch_bytes=1024)
        for i in range(5):
            relay.write({"event": "mem", "role": "worker", "rss_bytes": i})
        assert relay.dropped == 2 and relay.flush() == 3 and relay.sent == 3
    assert sent[0] == sent[1] and [e["rss_bytes"] for e in sent[0]["events"]] == [0, 1, 2]
    assert validate_event(relay.stats_record()) == []
    failing = RelaySink(lambda b: 1 / 0, role="worker")
    failing.write({"event": "mem", "role": "worker", "rss_bytes": 1})
    assert failing.flush() == 0 and failing.dropped == 1  # counted, never raised
    tee = TeeSink(None, RelaySink(lambda b: True, role="worker"))
    tee.write({"event": "mem", "role": "worker", "rss_bytes": 1})
    tee.close()

    events = []
    prof = tracing.RemoteProfiler(tmp_path / "profile", emit=events.append, role="worker")
    trace_dir = prof.start(0.05)
    assert trace_dir and prof.start(0.05) is None  # one window at a time
    sum(i * i for i in range(1000))
    import time

    time.sleep(0.06)
    prof.poll()
    assert not prof.active and [e["action"] for e in events] == ["started", "stopped"]
    assert json.load(open(f"{trace_dir}/trace.json"))["traceEvents"] is not None
    assert all(validate_event(e) == [] for e in events)


@pytest.mark.parametrize("platform", ["gpu", "cuda", "tpu"])
def test_worker_platform_accepts_only_the_cpu_the_programs_act_on(platform):
    from sheeprl_tpu_torch.fleet.supervisor import FleetSupervisor, worker_env

    assert worker_env("cpu") == {"CUDA_VISIBLE_DEVICES": ""}
    with pytest.raises(ValueError, match="device the workers act on"):
        worker_env(platform)
    with pytest.raises(ValueError, match="must be 'cpu'"):
        FleetSupervisor({}, program="sac", num_workers=1, worker_platform=platform)
