"""One DreamerV3 train step at dp=2: the port on two gloo ranks against the
JAX package on ``Distributed(devices=2)``, and against itself on one rank
(the helpers and PPO's and SAC's steps: tests/test_torch_mesh_steps.py).

Decoupled, through the JAX package's interpret-mode Pallas LN-GRU and the
port's plain LN-GRU passes (``pallas_gru=True`` on the CPU), from the same
converted parameters and Adam states, the same seed-made global batch of 4
columns and the JAX step's own gumbel draws. Each port rank takes its two
columns and their draws, averages each optimizer's gradients with the other
rank's in one all-reduce, and takes Moments' quantiles of the gathered
λ-returns. Tolerances as tests/test_torch_dreamer_v3.py: the ten metrics
(the mean of the two ranks' means) at rel 1e-4, the parameters at atol 5e-6,
the Adam moments at rel 1e-4 of their tensor's largest entry, Moments at rel
1e-4. Both ranks end with bitwise the same parameters.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_worker as W
from sheeprl_tpu_torch import convert
from test_torch_mesh_steps import METRIC_RTOL, MOMENT_RTOL, _close_adam, _close_state, _same_on_both_ranks

PARAM_ATOL_DV3 = 5e-6


def _dv3_noise(key, cfg, T: int, B: int, n_act: int):
    """The JAX decoupled step's gumbel draws from ``key`` for a global batch
    of ``B`` columns (tests/test_torch_dreamer_v3.py's layout)."""
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    horizon, TB = int(cfg.algo.horizon), T * B
    k_dyn, k_img, _ = jax.random.split(key, 3)
    post = jax.random.gumbel(k_dyn, (T, B, S, D))
    k0, k = jax.random.split(k_img)
    act0 = [jax.random.gumbel(jax.random.split(k0, 1)[0], (TB, n_act))]
    img_z, img_a = [], []
    for ks in jax.random.split(k, horizon):
        k_img_s, k_a = jax.random.split(ks)
        img_z.append(jax.random.gumbel(k_img_s, (TB, S, D)))
        img_a.append(jax.random.gumbel(jax.random.split(k_a, 1)[0], (TB, n_act)))
    n = lambda x: np.array(x)  # noqa: E731
    return {"post": n(post), "act0": [n(a) for a in act0], "img_z": n(jnp.stack(img_z)),
            "img_a": [n(jnp.stack(img_a))]}


def test_dreamer_v3_step_at_dp2_matches_jax(tmp_path):
    from dreamer_tiny import N_ACT, make_trainer
    from test_torch_dreamer_v3 import XLA, _numpy_tree, condition_two_hot_heads, torch_trainer

    dec = ["algo.world_model.decoupled_rssm=True"]
    train, params, opt_states, moments, jdist = make_trainer(XLA + dec + ["algo.world_model.pallas_gru=interpret"],
                                                             devices=2, return_dist=True)
    params0, opt0 = condition_two_hot_heads(_numpy_tree(params)), _numpy_tree(opt_states)
    T, B = 4, 4  # two columns a rank
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3), np.uint8),
             "actions": np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))],
             "rewards": rng.standard_normal((1, T, B, 1)).astype(np.float32),
             "terminated": np.zeros((1, T, B, 1), np.float32), "truncated": np.zeros((1, T, B, 1), np.float32),
             "is_first": np.zeros((1, T, B, 1), np.float32)}
    keys = jax.random.split(jax.random.key(7), 1)
    sharded = {k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(2)) for k, v in batch.items()}
    j_params, j_opt, j_moments, j_metrics = train(jax.tree.map(jnp.asarray, params0), opt_states, moments, sharded,
                                                  keys)

    tover = dec + ["algo.world_model.pallas_gru=True"]
    cfg, (wm, actor, critic, target), opts, _ = torch_trainer(tover)
    convert.load_dreamer_v3(params0, wm, actor, critic, target, opt0, opts)
    payload = {"cfg": cfg.to_dict(), "actions_dim": [N_ACT], "batch": batch,
               "modules": {"wm": wm, "actor": actor, "critic": critic, "target_critic": target},
               "opt_states": {k: getattr(opts, k).optimizer.state_dict() for k in ("wm", "actor", "critic")},
               "noise": [_dv3_noise(keys[0], cfg, T, B, N_ACT)]}
    outs = W.launch_ranks(W.dv3_step, payload, tmp_path)
    _same_on_both_ranks(outs, "state")

    # the JAX step's results in the port's layout
    ecfg, (ewm, eactor, ecritic, etarget), eopts, _ = torch_trainer(tover)
    convert.load_dreamer_v3(_numpy_tree(j_params), ewm, eactor, ecritic, etarget, _numpy_tree(j_opt), eopts)
    for k in j_metrics:
        got = np.mean([o["metrics"][k] for o in outs])
        assert got == pytest.approx(float(np.asarray(j_metrics[k])[0]), rel=METRIC_RTOL), k
    for name, m in (("wm", ewm), ("actor", eactor), ("critic", ecritic), ("target_critic", etarget)):
        _close_state(outs[0]["state"][name], m.state_dict(), PARAM_ATOL_DV3, name)
    for name in ("wm", "actor", "critic"):
        _close_adam(outs[0]["opt_states"][name], getattr(eopts, name).optimizer.state_dict(), MOMENT_RTOL, name)
    np.testing.assert_allclose(outs[0]["moments"], [float(j_moments.low), float(j_moments.high)], rtol=METRIC_RTOL)
    # each optimizer step: one all-reduce of the whole gradient (three
    # optimizers), Moments: one all-gather of the λ-returns
    assert outs[0]["stats"]["all_reduce"] == 3 and outs[0]["stats"]["all_gather"] == 1

    # the port on one rank on the whole batch
    cfg1, (wm1, actor1, critic1, target1), opts1, _ = torch_trainer(tover)
    convert.load_dreamer_v3(params0, wm1, actor1, critic1, target1, opt0, opts1)
    one = W.run_here(W.dv3_step, {**payload, "modules": {"wm": wm1, "actor": actor1, "critic": critic1,
                                                         "target_critic": target1},
                                  "opt_states": {k: getattr(opts1, k).optimizer.state_dict()
                                                 for k in ("wm", "actor", "critic")}})
    for name in ("wm", "actor", "critic", "target_critic"):
        _close_state(outs[0]["state"][name], one["state"][name], PARAM_ATOL_DV3, name)
    for k, v in one["metrics"].items():
        assert np.mean([o["metrics"][k] for o in outs]) == pytest.approx(v, rel=METRIC_RTOL), k
    np.testing.assert_allclose(outs[0]["moments"], one["moments"], rtol=METRIC_RTOL)
    assert one["stats"]["all_reduce"] == 0  # no group at world size 1
