"""DreamerV1 in the PyTorch port against the JAX package, on the CPU, at the
JAX package's CLI-test sizes (dense 8, one MLP layer, multiplier 2,
recurrent 16, stochastic 4, 64x64 frames and a vector key), from the same
converted parameters:

* the recurrent cell against flax's ``nn.GRUCell`` (the converter stacks
  flax's six kernels into the port's ``GRUCell``), forward and gradients;
* the Gaussian RSSM's ``dynamic`` (no ``is_first`` reset) and
  ``imagination`` with the JAX draws injected, and the Gaussian KL;
* the world-model loss, with and without the continue head;
* DreamerV1's λ-values;
* one G = 3 burst of ``make_train_fn``: the ten losses, every parameter and
  the Adam states, with discrete and ``trunc_normal`` actors under both
  ``conv_impl``, and with the continue head; the actor's gradient reaches
  the actor alone;
* a player step with the preset's exploration noise (0.3);
* CLI runs on the CPU at cut widths: a dry run, a short run, ``eval``.

Tolerances, with the largest differences measured (``PYTHONPATH=. python
tests/torch_dreamer.py``): the cell, forwards and the player atol 1e-5
(2.7e-7); losses and λ-values rel 1e-5 (2.0e-7); the burst's losses rel
1e-5 (4.0e-6) and parameters atol 5e-6 (2.1e-7; an Adam step moves a
weight by at most lr = 6e-4), the Adam moments rel 1e-4 of each tensor's
largest (2.0e-5).
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1 import dreamer_v1 as jdv1
from sheeprl_tpu.algos.dreamer_v1 import loss as jloss
from sheeprl_tpu.algos.dreamer_v1 import utils as jutils
from sheeprl_tpu.distributions import Bernoulli as JBernoulli
from sheeprl_tpu.distributions import Independent as JIndependent
from sheeprl_tpu.distributions import Normal as JNormal
from sheeprl_tpu.distributions import kl_divergence as jax_kl
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as tdv1
from sheeprl_tpu_torch.algos.dreamer_v1 import loss as tloss
from sheeprl_tpu_torch.algos.dreamer_v1 import utils as tutils
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers
from sheeprl_tpu_torch.distributions import Bernoulli, Independent, Normal, kl_divergence
from sheeprl_tpu_torch.models import GRUCell
from torch_dreamer import (actions_dim, agents, jax_player_noise, jax_train_noise, jax_txs, numpy_tree, obs_batch,
                           replay_batch, t)
from torch_offpolicy import adam_diff, max_diff

FWD_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-6
MOMENT_RTOL = 1e-4


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_gru_cell_matches_flax_forward_and_gradients():
    """Every gradient of the six flax parameters lands in the stacked one:
    no hidden r/z bias exists to take a second copy of the input bias's."""
    rng = np.random.default_rng(0)
    cell = fnn.GRUCell(features=5)
    h, x = rng.standard_normal((3, 5)).astype(np.float32), rng.standard_normal((3, 4)).astype(np.float32)
    params = cell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params)
    tcell = GRUCell(4, 5)
    convert.load_params(params, tcell)
    assert sorted(n for n, _ in tcell.named_parameters()) == ["bias_hn", "bias_i", "weight_h", "weight_i"]

    def jloss_fn(p, h):
        return jnp.sum(jnp.sin(cell.apply({"params": p}, h, jnp.asarray(x))[0]))

    jval, (jgp, jgh) = jax.value_and_grad(jloss_fn, argnums=(0, 1))(params, jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    tval = torch.sin(tcell(th, torch.from_numpy(x))).sum()
    tval.backward()
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=0, atol=FWD_ATOL)
    want = convert.params_to_state_dict(numpy_tree(jgp), tcell)
    for name, p in tcell.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=FWD_ATOL, err_msg=name)


def test_rssm_dynamic_and_imagination_match_flax():
    _, _, (wm, _, _), params, (twm, *_) = agents("dreamer_v1", [], False)
    rng = np.random.default_rng(1)
    B, S, R = 3, 4, 16
    post, h = rng.standard_normal((B, S)).astype(np.float32), rng.standard_normal((B, R)).astype(np.float32)
    a = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]
    emb = rng.standard_normal((B, 72)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    noise = t(jax.random.normal(key, (B, S)))
    j = wm.apply({"params": params["wm"]}, *map(jnp.asarray, (post, h, a, emb)), key, method="dynamic")
    with torch.no_grad():
        tt = twm.rssm.dynamic(*map(torch.from_numpy, (post, h, a, emb)), noise=noise)
    for got, want in zip(jax.tree.leaves(tuple(x for x in tt)), jax.tree.leaves(j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    j = wm.apply({"params": params["wm"]}, *map(jnp.asarray, (post, h, a)), key, method="imagination")
    with torch.no_grad():
        tt = twm.rssm.imagination(*map(torch.from_numpy, (post, h, a)), noise=noise)
    for got, want in zip(tt, j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    # the Gaussian KL of DreamerV1's state
    m1, s1, m2, s2 = (np.abs(rng.standard_normal((4, S))).astype(np.float32) + 0.1 for _ in range(4))
    jk = jax_kl(JIndependent(JNormal(jnp.asarray(m1), jnp.asarray(s1)), 1),
                JIndependent(JNormal(jnp.asarray(m2), jnp.asarray(s2)), 1))
    tk = kl_divergence(Independent(Normal(torch.from_numpy(m1), torch.from_numpy(s1)), 1),
                       Independent(Normal(torch.from_numpy(m2), torch.from_numpy(s2)), 1))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=LOSS_RTOL)


@pytest.mark.parametrize("continues", [False, True])
def test_reconstruction_loss_and_lambda_values_match_jax(continues):
    rng = np.random.default_rng(3)
    T, B, S = 3, 2, 4
    rec, obs = (rng.standard_normal((T, B, 64, 64, 3)).astype(np.float32) for _ in range(2))
    rew, rmean = (rng.standard_normal((T, B, 1)).astype(np.float32) for _ in range(2))
    pm, ps, qm, qs = (np.abs(rng.standard_normal((T, B, S))).astype(np.float32) + 0.2 for _ in range(4))
    logits, targets = rng.standard_normal((T, B, 1)).astype(np.float32), rng.random((T, B, 1)).astype(np.float32)
    j = jloss.reconstruction_loss(
        {"rgb": JIndependent(JNormal(jnp.asarray(rec), 1.0), 3)}, {"rgb": jnp.asarray(obs)},
        JIndependent(JNormal(jnp.asarray(rmean), 1.0), 1), jnp.asarray(rew),
        JIndependent(JNormal(jnp.asarray(pm), jnp.asarray(ps)), 1), JIndependent(JNormal(jnp.asarray(qm), jnp.asarray(qs)), 1),
        0.5, 1.0, JIndependent(JBernoulli(logits=jnp.asarray(logits)), 1) if continues else None,
        jnp.asarray(targets) if continues else None, 10.0)
    tt = tloss.reconstruction_loss(
        {"rgb": Independent(Normal(torch.from_numpy(rec), 1.0), 3)}, {"rgb": torch.from_numpy(obs)},
        Independent(Normal(torch.from_numpy(rmean), 1.0), 1), torch.from_numpy(rew),
        Independent(Normal(torch.from_numpy(pm), torch.from_numpy(ps)), 1),
        Independent(Normal(torch.from_numpy(qm), torch.from_numpy(qs)), 1),
        0.5, 1.0, Independent(Bernoulli(logits=torch.from_numpy(logits)), 1) if continues else None,
        torch.from_numpy(targets) if continues else None, 10.0)
    for got, want in zip(tt, j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-6)
    H = 5
    r, v, c = (rng.standard_normal((H, 4, 1)).astype(np.float32) for _ in range(3))
    jl = jutils.compute_lambda_values(jnp.asarray(r), jnp.asarray(v), jnp.asarray(c), jnp.asarray(v[-1]), H, 0.9)
    tl = tutils.compute_lambda_values(*map(torch.from_numpy, (r, v, c, v[-1])), horizon=H, lmbda=0.9)
    assert tl.shape == (H - 1, 4, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL, atol=1e-6)


BURSTS = [("einsum", False, []), ("xla", True, []), ("xla", False, []), ("einsum", True, ["algo.world_model.use_continues=True"])]


@pytest.mark.parametrize("conv_impl,continuous,extra", BURSTS)
def test_train_burst_matches_jax(conv_impl, continuous, extra):
    jcfg, tcfg, (wm, actor, critic), params, mods = agents("dreamer_v1", extra, continuous, conv_impl)
    txs = jax_txs(jcfg)
    G, T, B = 3, 3, 2
    batch = replay_batch(np.random.default_rng(4), (G, T, B), continuous)
    keys = jax.random.split(jax.random.PRNGKey(5), G)
    train = jdv1.make_train_fn(wm, actor, critic, txs, jcfg, continuous, actions_dim(continuous))
    state = {k: txs[k].init(params[k]) for k in ("wm", "actor", "critic")}
    p2, s2, j_metrics = train(jax.tree.map(jnp.array, params), state, to_jax(batch), keys)
    p2, s2 = numpy_tree(p2), numpy_tree(s2)
    optimizers = build_optimizers(tcfg, *mods[:3])
    ttrain = tdv1.make_train_fn(*mods[:3], optimizers, tcfg, continuous, actions_dim(continuous))
    t_metrics = ttrain(to_torch(batch), noise=[jax_train_noise(k, tcfg, continuous, T, B, gaussian=True)
                                               for k in keys])
    for k in tdv1.METRIC_KEYS:
        np.testing.assert_allclose(t_metrics[k].numpy(), np.asarray(j_metrics[k]), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    for key, module in zip(("wm", "actor", "critic"), mods):
        max_diff(module, p2[key], PARAM_ATOL, key)
        adam_diff(getattr(optimizers, key).optimizer, module, s2[key], MOMENT_RTOL, key)
    assert optimizers.step == G


def test_actor_gradient_reaches_the_actor_alone():
    """The actor's loss backpropagates through imagination on the world model
    and the critic; their .grad and optimizer states stay as the world-model
    and critic updates left them."""
    _, tcfg, _, _, mods = agents("dreamer_v1", [], True)
    optimizers = build_optimizers(tcfg, *mods[:3])
    seen = {}
    real_step = optimizers.actor.step

    def step():
        seen["wm"] = [None if p.grad is None else p.grad.clone() for p in mods[0].parameters()]
        seen["critic"] = [p.grad for p in mods[2].parameters()]
        real_step()

    optimizers.actor.step = step
    wm_grads_after_wm = {}
    real_wm_step = optimizers.wm.step

    def wm_step():
        real_wm_step()
        wm_grads_after_wm["g"] = [None if p.grad is None else p.grad.clone() for p in mods[0].parameters()]

    optimizers.wm.step = wm_step
    ttrain = tdv1.make_train_fn(*mods[:3], optimizers, tcfg, True, actions_dim(True))
    ttrain(to_torch(replay_batch(np.random.default_rng(6), (1, 3, 2), True)), generator=torch.Generator().manual_seed(0))
    for before, at_actor in zip(wm_grads_after_wm["g"], seen["wm"]):
        assert torch.equal(before, at_actor)
    assert all(g is None for g in seen["critic"])  # the critic takes its first gradient after the actor's step
    assert all(p.grad is not None and float(p.grad.abs().sum()) > 0 for p in mods[1].parameters())


def test_player_step_with_exploration_matches_jax():
    jcfg, tcfg, (wm, actor, _), params, (twm, tactor, _, _) = agents("dreamer_v1", [], True)
    n = 3
    _, j_step, j_expl = jdv1.make_player(wm, actor, jcfg, actions_dim(True), True, n)
    _, t_step, t_expl = tdv1.make_player(twm, tactor, tcfg, actions_dim(True), True, n)
    assert t_expl(100) == j_expl(100) == 0.3
    rng = np.random.default_rng(7)
    jstate = (jnp.zeros((n, 16)), jnp.zeros((n, 4)), jnp.zeros((n, 2)))
    tstate = tuple(torch.zeros(x.shape) for x in jstate)
    key = jax.random.PRNGKey(8)
    for _ in range(2):
        obs = obs_batch(rng, (n,))
        env_a, a, jstate, next_key = j_step({"wm": params["wm"], "actor": params["actor"]}, obs, jstate, key,
                                            expl_amount=0.3)
        t_env, t_a, tstate = t_step(obs, tstate, noise=jax_player_noise(key, tcfg, True, n, gaussian=True),
                                    expl_amount=0.3)
        key = next_key
        np.testing.assert_allclose(t_a.numpy(), np.asarray(a), rtol=0, atol=FWD_ATOL)
        for got, want in zip(tstate, jstate):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    assert float(np.abs(np.asarray(a)).max()) <= 1.0


RUN = ["exp=dreamer_v1", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "algo.dense_units=8",
       "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
       "algo.world_model.recurrent_model.recurrent_state_size=16", "algo.world_model.transition_model.hidden_size=8",
       "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
       "algo.per_rank_sequence_length=2", "algo.per_rank_batch_size=2", "algo.horizon=3", "buffer.memmap=False"]


def test_cli_dry_run_short_run_and_eval_on_cpu(capsys):
    cli.run(RUN + ["dry_run=True", "run_name=dry"])
    out = capsys.readouterr().out
    assert "[dreamer_v1] log_dir=" in out and "Test - Reward:" in out
    cli.run(RUN + ["algo.learning_starts=8", "algo.total_steps=16", "algo.replay_ratio=0.5", "buffer.size=32",
                   "checkpoint.every=8", "algo.run_test=False", "run_name=short"])
    ckpt = sorted(glob.glob("logs/runs/dreamer_v1/*/short/version_0/checkpoint/*.ckpt"),
                  key=lambda p: int(p[:-5].split("_")[-1]))[-1]
    state = torch.load(ckpt, weights_only=False)
    assert state["policy_step"] == 16 and state["opt_states"]["step"] == state["grad_steps"] > 0
    assert "target_critic" not in state and "is_first" not in state["rb"]["buffers"][0]["buffer"]
    capsys.readouterr()
    cli.evaluation([f"checkpoint_path={ckpt}"])
    assert "Test - Reward:" in capsys.readouterr().out
