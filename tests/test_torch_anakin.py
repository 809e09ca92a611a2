"""The Anakin program of the PyTorch port (``sheeprl_tpu_torch/fleet/anakin.py``)
against the JAX package's fused scan (``sheeprl_tpu.fleet.anakin.build_anakin``)
on the CPU: the same dynamics ``A`` and ``B``, policy parameters and first
states carried over from the JAX build, a chunk of batched steps against the
JAX ``lax.scan`` (atol 1e-5: f32 products summed in another order), first
with a horizon longer than the steps run, then across episodic resets whose
fresh states are the JAX package's draws, passed in through ``reset_rows``.
Also: the same seed gives the same run, and the fleet program adopts a
publication of its policy's shapes and ignores any other."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import numpy as np
import torch

from sheeprl_tpu_torch.config import Config
from sheeprl_tpu_torch.engine import RecordingSink
from sheeprl_tpu_torch.fleet.anakin import anakin_program, build_anakin, run_anakin

ATOL = 1e-5


def _cfg(slots=8, chunk=6, horizon=128):
    return Config({"seed": 5, "fleet": {"anakin": {"slots": slots, "chunk": chunk, "obs_dim": 6, "act_dim": 3,
                                                   "hidden": 10, "horizon": horizon}}})


def _jax_reset_rows(jkey, slots):
    """The JAX package's reset draw of every lane at step ``t`` of chunk
    ``c``: ``normal(fold_in(fold_in(key_c, t), slot))`` with the carry key
    folded once per chunk."""
    def rows(t, c):
        key = jkey
        for _ in range(c):
            key = jax.random.fold_in(key, 1)
        k = jax.random.fold_in(key, t)
        return torch.from_numpy(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, s), (6,)))
                                          for s in range(slots)]))
    return rows


def _carry_over(cfg):
    """The JAX build's A, B (recomputed from its key schedule, as
    ``build_anakin`` draws them), parameters and first states, set into the
    port's build."""
    from sheeprl_tpu.fleet.anakin import build_anakin as jax_build

    a = cfg.fleet.anakin
    k_env, _, _, _ = jax.random.split(jax.random.PRNGKey(int(cfg.seed)), 4)
    ka, kb = jax.random.split(k_env)
    A = np.asarray(jax.random.normal(ka, (a.obs_dim, a.obs_dim)) * (0.9 / np.sqrt(a.obs_dim)))
    B = np.asarray(jax.random.normal(kb, (a.act_dim, a.obs_dim)) * (1.0 / np.sqrt(a.act_dim)))
    jparams, jcarry, jscan, slots, _ = jax_build(cfg)
    return A, B, jparams, jcarry, jscan, slots


def _port(cfg, A, B, jparams, jcarry, reset_rows=None):
    params, carry, chunk_fn, _, _ = build_anakin(cfg, reset_rows=reset_rows)
    env = chunk_fn.__self__
    env.A, env.B = torch.tensor(A), torch.tensor(B)
    params = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    carry = (torch.tensor(np.asarray(jcarry[0])), 0, 0)
    return params, carry, chunk_fn


def test_chunk_matches_the_jax_scan_without_resets():
    cfg = _cfg(horizon=128)
    A, B, jparams, jcarry, jscan, _ = _carry_over(cfg)
    params, carry, chunk_fn = _port(cfg, A, B, jparams, jcarry)
    for _ in range(2):  # two chunks: the carry goes on from the first
        jcarry, j_r = jscan(jparams, jcarry)
        carry, r = chunk_fn(params, carry)
        np.testing.assert_allclose(carry[0].numpy(), np.asarray(jcarry[0]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(float(r), float(j_r), atol=ATOL, rtol=0)
    assert carry[1] == int(np.asarray(jcarry[1])[0]) == 12


def test_chunk_matches_the_jax_scan_across_resets_with_the_jax_draws():
    cfg = _cfg(slots=4, chunk=5, horizon=3)
    A, B, jparams, jcarry, jscan, slots = _carry_over(cfg)
    params, carry, chunk_fn = _port(cfg, A, B, jparams, jcarry, reset_rows=_jax_reset_rows(jcarry[2], slots))
    for _ in range(2):  # resets at t = 3, 6, 9 across two chunks and two carry keys
        jcarry, j_r = jscan(jparams, jcarry)
        carry, r = chunk_fn(params, carry)
        np.testing.assert_allclose(carry[0].numpy(), np.asarray(jcarry[0]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(float(r), float(j_r), atol=ATOL, rtol=0)


def test_same_seed_same_run_and_reset_draws_from_the_generator():
    cfg = _cfg(slots=4, chunk=5, horizon=2)
    runs = []
    for _ in range(2):
        params, carry, chunk_fn, slots, chunk = build_anakin(cfg)
        for _ in range(2):
            carry, r = chunk_fn(params, carry)
        runs.append((carry[0].clone(), float(r)))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    other = build_anakin(Config({**cfg.to_dict(), "seed": 6}))
    assert not torch.equal(other[1][0], build_anakin(cfg)[1][0])
    # the standalone probe on the host: steps, time and the ops of a chunk
    res = run_anakin(cfg, min_steps=40, device="cpu")
    assert res["env_steps"] >= 40 and res["steps_per_s"] > 0 and res["ops_per_chunk"] >= 5 * 8


def test_program_adopts_a_matching_publication_and_ignores_a_foreign_one():
    cfg = _cfg()
    prog = anakin_program(cfg, 0, 2)
    before = {k: v.clone() for k, v in prog.params.items()}
    prog.set_params({"actor": {"fc.weight": np.zeros((4, 6), np.float32)}}, 1)  # a SAC-like snapshot
    assert all(torch.equal(prog.params[k], before[k]) for k in before)
    mine = {"policy": {k: np.full(tuple(v.shape), 0.5, np.float32) for k, v in before.items()}}
    prog.set_params(mine, 2)
    assert all(torch.equal(prog.params[k], torch.full_like(before[k], 0.5)) for k in before)
    sink = RecordingSink()
    n, payload = prog.step(sink)
    assert (n, payload) == (8 * 6, None) and prog.lifetime == 48
    assert sink.stats[0][0] == "Rewards/rew_avg" and np.isfinite(sink.stats[0][1])
    # another worker's program draws its own dynamics and states
    assert not torch.equal(anakin_program(cfg, 1, 2).carry[0], anakin_program(cfg, 0, 2).carry[0])
