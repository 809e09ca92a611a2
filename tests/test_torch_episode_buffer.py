"""The port's ``EpisodeBuffer`` against the JAX package's, on the same adds
from a numpy seed: the episodes it commits (split at ``terminated |
truncated``, shorter than ``minimum_episode_length`` dropped, the oldest
evicted past ``buffer_size``) and, for one seed, bitwise the same sampled
windows with ``prioritize_ends`` off and on, also after a checkpoint round
trip (``checkpoint_state_dict`` / ``load_state_dict`` carry the numpy
generator); memmap storage and the removal of an evicted episode's files;
and the replay feed: the staged prefetcher serves an episode buffer's
batches (also with ``buffer.device_cache=true``, which the sequential
device ring would take) and stages nothing before an episode is stored."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EpisodeBuffer as JaxEpisodeBuffer
from sheeprl_tpu_torch.config import Config
from sheeprl_tpu_torch.data import EpisodeBuffer
from sheeprl_tpu_torch.data.device_ring import make_sequential_prefetcher
from sheeprl_tpu_torch.data.prefetch import StagedPrefetcher

N_ENVS = 2
KEYS = ("rgb", "state")


def rows(rng: np.random.Generator, t: int, n: int = N_ENVS, p_done: float = 0.15):
    """[t, n, ...] rows with episode ends from ``rng``."""
    return {
        "rgb": rng.integers(0, 256, (t, n, 4, 4, 3), dtype=np.uint8),
        "state": rng.standard_normal((t, n, 3)).astype(np.float32),
        "actions": rng.standard_normal((t, n, 2)).astype(np.float32),
        "rewards": rng.standard_normal((t, n, 1)).astype(np.float32),
        "terminated": (rng.random((t, n, 1)) < p_done).astype(np.float32),
        "truncated": (rng.random((t, n, 1)) < p_done / 3).astype(np.float32),
        "is_first": np.zeros((t, n, 1), np.float32),
    }


def filled(size=96, min_len=3, prioritize_ends=False, seed=7, adds=12, **kw):
    """The port's and the JAX package's buffers after the same adds (some
    of one step, some of several; a few to one env only)."""
    a = EpisodeBuffer(size, minimum_episode_length=min_len, n_envs=N_ENVS, obs_keys=KEYS,
                      prioritize_ends=prioritize_ends, seed=seed, **kw)
    b = JaxEpisodeBuffer(size, minimum_episode_length=min_len, n_envs=N_ENVS, obs_keys=KEYS,
                         prioritize_ends=prioritize_ends, seed=seed)
    rng = np.random.default_rng(1)
    for i in range(adds):
        if i % 4 == 3:
            data = rows(rng, 2, n=1)
            a.add(data, indices=[1])
            b.add(data, indices=[1])
        else:
            data = rows(rng, 1 + i % 5)
            a.add(data)
            b.add(data)
    return a, b


def assert_same_samples(a, b, draws=3, **kw):
    for _ in range(draws):
        sa, sb = a.sample(**kw), b.sample(**kw)
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("prioritize_ends", [False, True])
def test_samples_are_bitwise_the_jax_packages(prioritize_ends):
    a, b = filled(prioritize_ends=prioritize_ends)
    assert len(a) == len(b) and len(a.buffer) == len(b.buffer) > 3
    for ea, eb in zip(a.buffer, b.buffer):
        for k in eb:
            np.testing.assert_array_equal(ea[k], eb[k])
    assert_same_samples(a, b, batch_size=4, sequence_length=3, n_samples=2)
    s = a.sample(batch_size=4, sequence_length=3, n_samples=2)
    assert s["rgb"].shape == (2, 3, 4, 4, 4, 3) and s["rgb"].dtype == np.uint8


def test_prioritize_ends_draws_more_episode_ends():
    a, _ = filled(prioritize_ends=True, adds=40, size=400)
    b, _ = filled(prioritize_ends=False, adds=40, size=400)
    ends = [float(buf.sample(batch_size=256, sequence_length=3)["terminated"][0, -1].mean()
                  + buf.sample(batch_size=256, sequence_length=3)["truncated"][0, -1].mean()) for buf in (a, b)]
    assert ends[0] > ends[1]


@pytest.mark.parametrize("prioritize_ends", [False, True])
def test_checkpoint_round_trip_continues_the_same_draws(prioritize_ends, tmp_path):
    a, b = filled(prioritize_ends=prioritize_ends)
    a.sample(batch_size=2, sequence_length=3)
    b.sample(batch_size=2, sequence_length=3)
    state = a.checkpoint_state_dict()
    assert all(o is None for o in state["open"])
    torch.save(state, tmp_path / "rb.ckpt")
    loaded = torch.load(tmp_path / "rb.ckpt", weights_only=False)
    c = EpisodeBuffer(96, minimum_episode_length=3, n_envs=N_ENVS, obs_keys=KEYS, prioritize_ends=prioritize_ends,
                      seed=123).load_state_dict(loaded)
    d = JaxEpisodeBuffer(96, minimum_episode_length=3, n_envs=N_ENVS, obs_keys=KEYS, prioritize_ends=prioritize_ends,
                         seed=123).load_state_dict(b.checkpoint_state_dict())
    assert_same_samples(c, d, batch_size=4, sequence_length=3, n_samples=2)
    # the resumed buffer draws what the original would have
    e = EpisodeBuffer(96, minimum_episode_length=3, n_envs=N_ENVS, obs_keys=KEYS, prioritize_ends=prioritize_ends,
                      seed=5).load_state_dict(loaded)
    assert_same_samples(a, e, batch_size=4, sequence_length=3)


def test_eviction_minimum_length_and_memmap_files(tmp_path):
    a, b = filled(size=40, min_len=4, adds=30, memmap=True, memmap_dir=tmp_path / "mm")
    assert len(a) == len(b) <= 40 and len(a.buffer) == len(b.buffer)
    assert all(len(ep["rewards"]) >= 4 for ep in a.buffer)
    dirs = sorted(p.name for p in (tmp_path / "mm").iterdir())
    assert len(dirs) == len(a.buffer) and a._episode_counter > len(a.buffer)  # evicted ones removed
    assert_same_samples(a, b, batch_size=3, sequence_length=4)
    with pytest.raises(ValueError, match="No episodes of length"):
        a.sample(batch_size=2, sequence_length=41)


def test_staged_prefetcher_serves_the_episode_buffer():
    """device_cache=true takes the ring for a sequential buffer, the staged
    prefetcher for an episode buffer; it stages nothing while no episode is
    stored, then serves [G, T, B, ...] batches with the images uint8."""
    cfg = Config({"buffer": {"device_cache": True}})
    rb = EpisodeBuffer(64, minimum_episode_length=2, n_envs=N_ENVS, obs_keys=KEYS, seed=3)
    pf = make_sequential_prefetcher(cfg, torch.device("cpu"), rb, 3, 2, cnn_keys=("rgb",), row_bytes_hint=100)
    assert isinstance(pf, StagedPrefetcher)
    pf.stage(2)  # nothing stored yet: nothing staged
    rng = np.random.default_rng(4)
    rb.add({**rows(rng, 5), "terminated": np.ones((5, N_ENVS, 1), np.float32)})
    rb.add(rows(rng, 6, p_done=0.5))
    pf.stage(2)
    batch = pf.take(2)
    assert batch["rgb"].shape == (2, 2, 3, 4, 4, 3) and batch["rgb"].dtype == torch.uint8
    assert batch["state"].dtype == torch.float32
    out = {k: np.empty_like(v.numpy()) for k, v in batch.items()}
    got = rb.sample(3, n_samples=2, sequence_length=2, out=out)
    assert got["rgb"] is out["rgb"]
