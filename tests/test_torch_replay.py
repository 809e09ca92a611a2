"""The port's replay feed against the JAX package: memmap buffers (add,
sample, checkpoint and resume, ``memmap_fast_resume`` included), the host
C++ gather, the staged prefetcher and the device ring (on the CPU here), all
fed from numpy seeds. Batches are compared bit for bit."""
import copy
import json
import os

import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxRB
from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSeq
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer, MemmapArray, native
from sheeprl_tpu_torch.data.device_ring import (
    DeviceRingPrefetcher,
    _use_ring,
    estimate_row_bytes,
    make_sequential_prefetcher,
)
from sheeprl_tpu_torch.data.prefetch import StagedPrefetcher

N_ENVS, L, B = 3, 5, 4


def _rows(rng, t, n_envs=N_ENVS):
    return {
        "rgb": rng.integers(0, 256, (t, n_envs, 8, 8, 3), dtype=np.uint8),
        "actions": rng.standard_normal((t, n_envs, 2)).astype(np.float32),
        "truncated": np.zeros((t, n_envs, 1), np.float32),
        "is_first": (rng.random((t, n_envs, 1)) < 0.2).astype(np.float32),
    }


def _pair(tmp_path, size=32, memmap=True, seed=3, **kw):
    mine = EnvIndependentReplayBuffer(size, n_envs=N_ENVS, obs_keys=("rgb",), memmap=memmap,
                                      memmap_dir=tmp_path / "mine" if memmap else None, seed=seed, **kw)
    ref = JaxRB(size, n_envs=N_ENVS, obs_keys=("rgb",), memmap=memmap, memmap_dir=tmp_path / "ref" if memmap else None,
                buffer_cls=JaxSeq, seed=seed)
    return mine, ref


def _fill(bufs, steps, seed=0, per_env=False):
    rng = np.random.default_rng(seed)
    for t in steps:
        data = _rows(rng, t)
        for b in bufs:
            b.add(data)
        if per_env:  # a reset row for env 1 alone, as the loop adds for finished episodes
            one = {k: v[:1, 1:2] for k, v in _rows(rng, 1).items()}
            for b in bufs:
                b.add(one, [1])


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _rng_state(rb):
    return copy.deepcopy([rb._rng.bit_generator.state] + [b._rng.bit_generator.state for b in rb.buffer])


def _set_rng_state(rb, st):
    rb._rng.bit_generator.state = st[0]
    for b, s in zip(rb.buffer, st[1:]):
        b._rng.bit_generator.state = s


@pytest.mark.parametrize("steps", [(7,), (20, 30), (50, 3)])
def test_memmap_buffer_adds_and_samples_as_jax(tmp_path, steps):
    mine, ref = _pair(tmp_path)
    _fill((mine, ref), steps, per_env=True)
    for g in (1, 3):
        _same(mine.sample(B, sequence_length=L, n_samples=g), ref.sample(B, sequence_length=L, n_samples=g))
    # one file per key under <memmap_dir>/env_<i>/
    files = sorted(p.relative_to(tmp_path / "mine").as_posix() for p in (tmp_path / "mine").rglob("*.memmap"))
    assert files == sorted(f"env_{i}/{k}.memmap" for i in range(N_ENVS) for k in ("rgb", "actions", "truncated", "is_first"))
    assert isinstance(mine.buffer[0]._buf["rgb"], MemmapArray)


def test_native_gather_equals_numpy_bitwise(tmp_path, monkeypatch):
    assert native.status()["loaded"], native.status()
    src = np.arange(60, dtype=np.float32).reshape(20, 3)
    idx = np.array([[4, 0], [19, 4]])
    np.testing.assert_array_equal(native.gather_rows(src, idx, (2, 2, 3)), src[idx])
    mine, _ = _pair(tmp_path, memmap=False)
    _fill((mine,), (40,))
    st = _rng_state(mine)
    fast = mine.sample(B, sequence_length=L, n_samples=2)
    monkeypatch.setattr(native, "gather_rows", lambda *a: None)  # where it is not built: numpy's gather
    _set_rng_state(mine, st)
    _same(fast, mine.sample(B, sequence_length=L, n_samples=2))


@pytest.mark.parametrize("fast", [False, True])
def test_memmap_checkpoint_resumes_as_jax(tmp_path, fast):
    """The checkpoint state (rows copied, or with memmap_fast_resume the
    flushed files referenced) loads into a fresh buffer that samples what
    the JAX package's resumed buffer samples, with the write-head row
    marked truncated in the copy only."""
    mine, ref = _pair(tmp_path, memmap_fast_resume=fast)
    JaxReplayBuffer.memmap_fast_resume = fast
    try:
        _fill((mine, ref), (9, 12))
        s_mine, s_ref = mine.checkpoint_state_dict(), ref.checkpoint_state_dict()
    finally:
        JaxReplayBuffer.memmap_fast_resume = False
    assert all(bool(b.get("__memmap_ref__")) == fast for b in s_mine["buffers"])
    for b in mine.buffer:  # the live buffer keeps its flags
        assert b["truncated"][(b._pos - 1) % b.buffer_size].max() == 0
    mine2, ref2 = _pair(tmp_path / "resumed")
    mine2.load_state_dict(s_mine)
    ref2.load_state_dict(s_ref)
    for b in mine2.buffer:
        assert b["truncated"][(b._pos - 1) % b.buffer_size].min() == 1
    _same(mine2.sample(B, sequence_length=L, n_samples=2), ref2.sample(B, sequence_length=L, n_samples=2))
    _fill((mine2, ref2), (4,), seed=1)
    _same(mine2.sample(B, sequence_length=L), ref2.sample(B, sequence_length=L))


def test_fast_resume_refuses_a_missing_file(tmp_path):
    mine, _ = _pair(tmp_path, memmap_fast_resume=True)
    _fill((mine,), (6,))
    state = mine.checkpoint_state_dict()
    (tmp_path / "mine" / "env_0" / "rgb.memmap").unlink()
    fresh, _ = _pair(tmp_path / "resumed")
    with pytest.raises(FileNotFoundError, match="memmap_fast_resume"):
        fresh.load_state_dict(state)


def _host_sample(rb, g, out=None):
    s = rb.sample(B, sequence_length=L, n_samples=g, out=out)
    return {k: v if k == "rgb" else np.asarray(v, np.float32) for k, v in s.items()}


def test_staged_batches_equal_the_host_sample(tmp_path):
    """stage/take on the CPU: the staged batch is the sample the host buffer
    gives for the same generator state; a mismatched g and the warmup
    boundary sample synchronously."""
    rb, _ = _pair(tmp_path, memmap=False)
    pf = StagedPrefetcher(lambda g, out=None: _host_sample(rb, g, out), torch.device("cpu"))
    pf.stage(1)  # the warmup boundary: an empty buffer stages nothing
    with pytest.raises(ValueError):
        pf.take(1)
    _fill((rb,), (3,))
    pf.stage(1)  # 3 rows < L: still nothing
    _fill((rb,), (20,))
    st = _rng_state(rb)
    pf.stage(2)
    got = pf.take(2)
    _set_rng_state(rb, st)
    _same({k: v.numpy() for k, v in got.items()}, _host_sample(rb, 2))
    pf.stage(1)
    st = _rng_state(rb)  # after the stage's draws
    got = pf.take(3)  # not the staged g: a fresh sample
    _set_rng_state(rb, st)
    _same({k: v.numpy() for k, v in got.items()}, _host_sample(rb, 3))


def _ring_vs_host(rb, ring, g):
    st = _rng_state(rb)
    got = ring.take(g)
    _set_rng_state(rb, st)
    _same({k: v.numpy() for k, v in got.items()}, _host_sample(rb, g))


@pytest.mark.parametrize("steps", [(12,), (20, 50), (31, 33, 40)])
def test_ring_batches_equal_the_host_sample(tmp_path, steps):
    rb, _ = _pair(tmp_path, memmap=False)
    ring = DeviceRingPrefetcher(rb, B, L, cnn_keys=("rgb",), device="cpu")
    for i, t in enumerate(steps):
        _fill((rb,), (t,), seed=i, per_env=True)
        _ring_vs_host(rb, ring, 1 + i % 2)
    assert ring.ring["rgb"].dtype == torch.uint8 and tuple(ring.ring["rgb"].shape[:2]) == (32, N_ENVS)
    # staged one ahead, then more rows: the staged batch is the one drawn at stage time
    st = _rng_state(rb)
    ring.stage(2)
    staged = {k: v.clone() for k, v in ring.take(2).items()}
    _set_rng_state(rb, st)
    _same({k: v.numpy() for k, v in staged.items()}, _host_sample(rb, 2))


def test_ring_reships_rows_a_restart_rewrote_and_resyncs_after_a_load(tmp_path):
    rb, _ = _pair(tmp_path, memmap=False)
    ring = DeviceRingPrefetcher(rb, B, L, cnn_keys=("rgb",), device="cpu")
    _fill((rb,), (10,))
    ring.sync()
    rb.mark_restart(2)  # rewrites env 2's last row in place: mark_dirty re-ships it
    row = (rb.buffer[2]._pos - 1) % 32
    assert ring._dirty_rows == [(2, row)]
    ring.sync()
    assert float(ring.ring["truncated"][row, 2]) == 1.0 and float(ring.ring["is_first"][row, 2]) == 0.0
    _ring_vs_host(rb, ring, 1)
    state = copy.deepcopy(rb.state_dict())
    _fill((rb,), (40,), seed=4)
    ring.sync()
    rb.load_state_dict(state)  # a checkpoint load rewrites the host buffer
    ring.resync()
    _ring_vs_host(rb, ring, 2)
    np.testing.assert_array_equal(ring.ring["rgb"][:10].numpy(), np.concatenate(
        [b["rgb"][:10] for b in rb.buffer], axis=1))


class _Dist:
    """The JAX package's view of a single-device mesh."""

    def __init__(self, platform):
        self.world_size = 1
        self.devices = [type("D", (), {"platform": platform})()]


@pytest.mark.parametrize("mode", ["auto", "true", "false", True, False, None])
@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("rows", [1000, 10**6])
def test_use_ring_decides_as_jax(mode, platform, rows):
    from sheeprl_tpu.config import Config as JaxConfig
    from sheeprl_tpu.data.device_ring import _use_ring as jax_use_ring
    from sheeprl_tpu_torch.config import Config

    raw = {"buffer": {"device_cache": mode, "device_cache_max_bytes": 6_000_000_000}}
    row_bytes = 12_328
    want = jax_use_ring(JaxConfig(raw), _Dist(platform), row_bytes, rows)
    device = torch.device("cuda" if platform == "gpu" else "cpu")
    assert _use_ring(Config(raw), device, row_bytes, rows) == want


def test_estimate_row_bytes_as_jax_on_the_walker_row():
    import gymnasium as gym
    from sheeprl_tpu.data.device_ring import estimate_row_bytes as jax_estimate
    from sheeprl_tpu_torch.envs import spaces

    mine = estimate_row_bytes(spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}), 6)
    ref = jax_estimate(gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)}), 6)
    assert mine == ref == 64 * 64 * 3 + 6 * 4 + 16


def test_make_sequential_prefetcher_picks_by_config(tmp_path, capsys):
    from sheeprl_tpu_torch.config import Config

    rb, _ = _pair(tmp_path, memmap=False)
    cpu = torch.device("cpu")
    pick = lambda mode: make_sequential_prefetcher(  # noqa: E731
        Config({"buffer": {"device_cache": mode}}), cpu, rb, B, L, cnn_keys=("rgb",), row_bytes_hint=100)
    assert isinstance(pick("true"), DeviceRingPrefetcher)
    assert isinstance(pick("auto"), StagedPrefetcher)  # the CPU takes no ring unless forced
    assert isinstance(pick("false"), StagedPrefetcher)
    assert "[prefetch] StagedPrefetcher" in capsys.readouterr().err


def test_cli_ring_and_staged_feeds_train_on_the_same_batches(tmp_path, monkeypatch, capsys):
    """The serial loop on the device ring and on the staged prefetcher: the
    same batches, so the same losses and the same ledger."""
    from dreamer_tiny import TINY_DV3
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    args = TINY_DV3 + ["fabric.accelerator=cpu", "env.num_envs=2", "algo.learning_starts=8", "algo.replay_ratio=0.5",
                       "buffer.size=64", "metric.log_every=8", "algo.run_test=False", "algo.total_steps=24",
                       "checkpoint.every=0", "algo.overlap.enabled=False"]
    lines = {}
    for feed in ("true", "false"):
        cli.run(args + [f"buffer.device_cache={feed}", f"run_name=feed_{feed}"])
        out = capsys.readouterr()
        assert ("DeviceRingPrefetcher" if feed == "true" else "StagedPrefetcher") in out.err
        log_dir = next(l.split("=", 1)[1] for l in out.out.splitlines() if l.startswith("[dreamer_v3] log_dir="))
        with open(os.path.join(log_dir, "telemetry.jsonl")) as fh:  # the log records without the clock's fields
            lines[feed] = [(r["step"], r["grad_steps"], r["metrics"])
                           for r in map(json.loads, fh) if r["event"] == "log"]
    assert lines["true"] == lines["false"] and "Loss/world_model_loss" in lines["true"][-1][2]
