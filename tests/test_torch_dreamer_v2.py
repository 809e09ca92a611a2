"""DreamerV2 in the PyTorch port against the JAX package, on the CPU, at the
JAX package's CLI-test sizes (dense 8, one MLP layer, multiplier 2,
recurrent 16, stochastic 4x4, 64x64 frames and a vector key), from the same
converted parameters:

* the encoder and decoder forward under ``conv_impl=einsum`` and ``xla``
  (the decoder's ``transpose_kernel=False`` deconvolutions flipped in space
  by the converter), and with ``algo.layer_norm`` at multiplier 4;
* the RSSM's ``dynamic`` (with an ``is_first`` reset) and ``imagination``
  with the JAX draws injected;
* the actor distributions (discrete, ``trunc_normal``, ``tanh_normal``,
  ``normal``): ``log_prob``, ``entropy``, ``mode`` and ``rsample`` from the
  same uniform or normal;
* the world-model loss with ``kl_free_avg`` on and off and the continue head;
* one G = 3 burst of ``make_train_fn`` (the target copy due at steps 0 and
  2): the ten losses, every parameter, the target critic, the Adam(W)
  states and the step counter, with discrete and ``trunc_normal`` actors
  under both ``conv_impl``, and with ``tanh_normal``, ``objective_mix`` 0.5
  and the continue head;
* a player step with exploration noise, discrete and continuous;
* ``rmsprop_tf`` against the JAX package's over a few steps;
* the presets composing to the JAX package's ``algo`` section;
* CLI runs on the CPU at cut widths: dry runs (sequential and episode
  buffers, discrete and continuous), ``eval``, a resume and the fleet
  refused.

The JAX package's DreamerV2 step calls ``nnprobs`` with the continue head
on, a name its module never defines; the continue-head burst gives it
``jax.nn.sigmoid`` (the probabilities the reference takes, and what the
port computes) for that test only.

Tolerances, with the largest differences measured (``PYTHONPATH=. python
tests/torch_dreamer.py``): forwards atol 1e-5 (7.2e-7), with
``layer_norm`` 5e-5 (1.4e-5: a LayerNorm over the first convolution's 4
channels divides by a standard deviation of few terms, and flax computes
the variance as E[x²] - E[x]², torch in two passes, so their f32 roundings
differ and the division amplifies them); the RSSM atol 1e-5 (3.0e-7); the
distributions rtol and atol 1e-5 (3.8e-6), also the truncated normal's
``log_prob``, ``entropy`` and ``rsample`` at saturated means (|tanh(μ)| >
0.99, where ``_Z`` is a difference of two CDFs near 1 and ``icdf`` runs
``erfinv`` near 1 - eps: torch's f32 ``erf``/``erfinv`` and XLA's could
part there, but agree to 8.9e-7 on these inputs), its ``mean``,
``variance``, ``cdf`` and ``icdf`` 1e-4; the losses rel 1e-5 (2.5e-7); the
burst's losses rel 1e-5 (5.1e-6) and parameters atol 5e-6 (1.3e-7; an Adam
step moves a weight by at most lr = 3e-4, and only a gradient of rounding
size could move one by a visible share of it), the Adam moments rel 1e-4 of
each tensor's largest (1.9e-5).
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2 import agent as jagent
from sheeprl_tpu.algos.dreamer_v2 import dreamer_v2 as jdv2
from sheeprl_tpu.algos.dreamer_v2 import loss as jloss
from sheeprl_tpu.distributions import Independent as JIndependent
from sheeprl_tpu.distributions import Normal as JNormal
from sheeprl_tpu.optim import rmsprop_tf as jax_rmsprop_tf
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.dreamer_v2 import agent as tagent
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as tdv2
from sheeprl_tpu_torch.algos.dreamer_v2 import loss as tloss
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers
from sheeprl_tpu_torch.distributions import Independent, Normal
from sheeprl_tpu_torch.optim import RMSpropTF, rmsprop_tf
from torch_dreamer import (C_ACT, F32_EPS, N_ACT, actions_dim, agents, jax_player_noise, jax_train_noise, jax_txs,
                           numpy_tree, obs_batch, replay_batch, t)
from torch_offpolicy import adam_diff, configs, max_diff, within

FWD_ATOL = 1e-5
LN_FWD_ATOL = 5e-5
DIST_TOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-6
MOMENT_RTOL = 1e-4


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("conv_impl,mult,layer_norm", [("einsum", 2, False), ("xla", 2, False), ("xla", 4, True)])
def test_encoder_and_decoder_forward_match_flax(conv_impl, mult, layer_norm):
    """Also with an asymmetric decoder kernel and non-zero biases: converted
    without the spatial flip the deconvolutions would not match."""
    over = [f"algo.world_model.encoder.cnn_channels_multiplier={mult}", f"algo.layer_norm={layer_norm}"]
    _, _, (wm, _, _), params, (twm, *_) = agents("dreamer_v2", over, False, conv_impl)
    rng = np.random.default_rng(1)
    wp = jax.tree.map(lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32), params["wm"])
    convert.load_params(wp, twm)
    obs = obs_batch(rng, (2, 3))
    norm = {"rgb": obs["rgb"].astype(np.float32) / 255.0 - 0.5, "state": obs["state"]}
    j_emb = wm.apply({"params": wp}, to_jax(norm), method="embed")
    latent = rng.standard_normal((2, 3, 16 + 16)).astype(np.float32)
    j_rec = wm.apply({"params": wp}, jnp.asarray(latent), method="decode")
    with torch.no_grad():
        t_emb = twm.embed(to_torch(norm))
        t_rec = twm.decode(torch.from_numpy(latent))
    assert t_emb.shape == (2, 3, 8 * mult * 4 + 8) and t_rec["rgb"].shape == (2, 3, 64, 64, 3)
    atol = LN_FWD_ATOL if layer_norm else FWD_ATOL
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=atol)
    for k in ("rgb", "state"):
        np.testing.assert_allclose(t_rec[k].numpy(), np.asarray(j_rec[k]), rtol=0, atol=atol, err_msg=k)
    dec = twm.observation_model.DV2CNNDecoder_0
    assert all(getattr(dec, n).flax_transpose_kernel is False for n in ("deconv_0", "deconv_1", "deconv_2", "to_obs"))
    with torch.no_grad():
        unflipped = wp["observation_model"]["DV2CNNDecoder_0"]["to_obs"]["kernel"].transpose(2, 3, 0, 1)
        dec.to_obs.weight.copy_(torch.from_numpy(np.ascontiguousarray(unflipped)))
        assert float((twm.decode(torch.from_numpy(latent))["rgb"] - t_rec["rgb"]).abs().max()) > 1e-3


def test_rssm_dynamic_and_imagination_match_flax():
    jcfg, tcfg, (wm, _, _), params, (twm, *_) = agents("dreamer_v2", [], False)
    rng = np.random.default_rng(2)
    B, S, D, R = 3, 4, 4, 16
    post = np.eye(D, dtype=np.float32)[rng.integers(0, D, (B, S))].reshape(B, S * D)
    h = rng.standard_normal((B, R)).astype(np.float32)
    a = np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, B)]
    emb = rng.standard_normal((B, 72)).astype(np.float32)
    first = np.array([[1.0], [0.0], [0.0]], np.float32)
    key = jax.random.PRNGKey(3)
    j = wm.apply({"params": params["wm"]}, *map(jnp.asarray, (post, h, a, emb, first)), key, method="dynamic")
    with torch.no_grad():
        tt = twm.rssm.dynamic(*map(torch.from_numpy, (post, h, a, emb, first)),
                              noise=t(jax.random.gumbel(key, (B, S, D))))
    for got, want in zip(tt, j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    j = wm.apply({"params": params["wm"]}, *map(jnp.asarray, (post, h, a)), key, method="imagination")
    with torch.no_grad():
        tt = twm.rssm.imagination(*map(torch.from_numpy, (post, h, a)), noise=t(jax.random.gumbel(key, (B, S, D))))
    for got, want in zip(tt, j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("kind", ["discrete", "trunc_normal", "tanh_normal", "normal"])
def test_actor_distributions_match_jax(kind):
    """Raw actor outputs wide enough to saturate the truncated normal's
    mean at some entries."""
    continuous = kind != "discrete"
    over = [] if kind == "discrete" else [f"distribution.type={kind}"]
    _, _, (_, actor, _), _, (_, tactor, _, _) = agents("dreamer_v2", over, continuous)
    rng = np.random.default_rng(4)
    pre = [(3.0 * rng.standard_normal((64, 2 * C_ACT if continuous else N_ACT))).astype(np.float32)]
    if kind == "normal":
        pre[0][:, C_ACT:] = np.abs(pre[0][:, C_ACT:]) + 0.1  # the raw std is the scale
    jd = jagent.dv2_actor_dists(actor, [jnp.asarray(p) for p in pre])[0]
    td = tagent.dv2_actor_dists(tactor, [torch.from_numpy(p) for p in pre])[0]
    key = jax.random.PRNGKey(5)
    shape = (64, C_ACT if continuous else N_ACT)
    if kind == "trunc_normal":
        noise = jax.random.uniform(key, shape, minval=F32_EPS, maxval=1 - F32_EPS)
    elif continuous:
        noise = jax.random.normal(key, shape)
    else:
        noise = jax.random.gumbel(key, shape)
    j_sample = np.asarray(jd.rsample(key))
    t_sample = td.rsample(t(noise)).numpy()
    np.testing.assert_allclose(t_sample, j_sample, rtol=DIST_TOL, atol=DIST_TOL)
    np.testing.assert_allclose(td.mode.numpy(), np.asarray(jd.mode), rtol=DIST_TOL, atol=DIST_TOL)
    value = j_sample if continuous else np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, 64)]
    j_lp, t_lp = np.asarray(jd.log_prob(jnp.asarray(value))), td.log_prob(torch.from_numpy(np.array(value))).numpy()
    if kind == "trunc_normal":  # the inputs reach saturated means
        saturated = (np.abs(np.tanh(pre[0][:, :C_ACT])) > 0.99).any(-1)
        assert saturated.any() and not saturated.all()
    np.testing.assert_allclose(t_lp, j_lp, rtol=DIST_TOL, atol=DIST_TOL)
    if kind == "tanh_normal":
        with pytest.raises(NotImplementedError):
            td.entropy()
        return
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()), rtol=DIST_TOL, atol=DIST_TOL)
    if kind == "trunc_normal":
        for name in ("mean", "variance"):
            np.testing.assert_allclose(getattr(td.base, name).numpy(), np.asarray(getattr(jd.base, name)),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        u = np.linspace(0.05, 0.95, 64 * C_ACT, dtype=np.float32).reshape(64, C_ACT)
        np.testing.assert_allclose(td.base.icdf(torch.from_numpy(u)).numpy(), np.asarray(jd.base.icdf(jnp.asarray(u))),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(td.base.cdf(torch.from_numpy(np.array(j_sample))).numpy(),
                                   np.asarray(jd.base.cdf(jnp.asarray(j_sample))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("free_avg,continues", [(True, False), (False, True)])
def test_reconstruction_loss_matches_jax(free_avg, continues):
    rng = np.random.default_rng(6)
    T, B, S, D = 3, 2, 4, 4
    rec = {"rgb": rng.standard_normal((T, B, 64, 64, 3)).astype(np.float32)}
    obs = {"rgb": rng.standard_normal((T, B, 64, 64, 3)).astype(np.float32)}
    rew, rmean = (rng.standard_normal((T, B, 1)).astype(np.float32) for _ in range(2))
    prior, post = (rng.standard_normal((T, B, S, D)).astype(np.float32) for _ in range(2))
    logits, targets = rng.standard_normal((T, B, 1)).astype(np.float32), rng.random((T, B, 1)).astype(np.float32)
    from sheeprl_tpu.distributions import Bernoulli as JBernoulli
    from sheeprl_tpu_torch.distributions import Bernoulli

    jpc = JIndependent(JBernoulli(logits=jnp.asarray(logits)), 1) if continues else None
    tpc = Independent(Bernoulli(logits=torch.from_numpy(logits)), 1) if continues else None
    args = (0.8, 1.0, free_avg, 1.0)
    j = jloss.reconstruction_loss({"rgb": JIndependent(JNormal(jnp.asarray(rec["rgb"]), 1.0), 3)}, to_jax(obs),
                                  JIndependent(JNormal(jnp.asarray(rmean), 1.0), 1), jnp.asarray(rew),
                                  jnp.asarray(prior), jnp.asarray(post), *args, jpc,
                                  jnp.asarray(targets) if continues else None, 0.5)
    tt = tloss.reconstruction_loss({"rgb": Independent(Normal(torch.from_numpy(rec["rgb"]), 1.0), 3)}, to_torch(obs),
                                   Independent(Normal(torch.from_numpy(rmean), 1.0), 1), torch.from_numpy(rew),
                                   torch.from_numpy(prior), torch.from_numpy(post), *args, tpc,
                                   torch.from_numpy(targets) if continues else None, 0.5)
    for got, want in zip(tt, j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-6)


def jax_state(jcfg, params, txs):
    return {"wm": txs["wm"].init(params["wm"]), "actor": txs["actor"].init(params["actor"]),
            "critic": txs["critic"].init(params["critic"]), "step": jnp.zeros((), jnp.int32)}


BURSTS = [
    ("einsum", False, []),
    ("xla", False, []),
    ("einsum", True, []),
    ("xla", True, []),
    ("xla", True, ["distribution.type=tanh_normal", "algo.actor.objective_mix=0.5", "algo.world_model.use_continues=True",
                   "algo.world_model.kl_free_avg=False"]),
]


@pytest.mark.parametrize("conv_impl,continuous,extra", BURSTS)
def test_train_burst_matches_jax(monkeypatch, conv_impl, continuous, extra):
    if "algo.world_model.use_continues=True" in extra:
        monkeypatch.setattr(jdv2, "nnprobs", jax.nn.sigmoid, raising=False)
    over = ["algo.critic.per_rank_target_network_update_freq=2", *extra]
    jcfg, tcfg, (wm, actor, critic), params, mods = agents("dreamer_v2", over, continuous, conv_impl)
    txs = jax_txs(jcfg)
    G, T, B = 3, 3, 2
    batch = replay_batch(np.random.default_rng(7), (G, T, B), continuous)
    keys = jax.random.split(jax.random.PRNGKey(8), G)
    train = jdv2.make_train_fn(wm, actor, critic, txs, jcfg, continuous, actions_dim(continuous))
    p2, s2, j_metrics = train(jax.tree.map(jnp.array, params), jax_state(jcfg, params, txs), to_jax(batch), keys)
    p2, s2 = numpy_tree(p2), numpy_tree(s2)
    optimizers = build_optimizers(tcfg, *mods[:3])
    assert isinstance(optimizers.wm.optimizer, torch.optim.AdamW)
    ttrain = tdv2.make_train_fn(*mods, optimizers, tcfg, continuous, actions_dim(continuous))
    noise = [jax_train_noise(k, tcfg, continuous, T, B) for k in keys]
    t_metrics = ttrain(to_torch(batch), noise=noise)
    for k in tdv2.METRIC_KEYS:
        np.testing.assert_allclose(t_metrics[k].numpy(), np.asarray(j_metrics[k]), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    for key, module in zip(("wm", "actor", "critic", "target_critic"), mods):
        max_diff(module, p2[key], PARAM_ATOL, key)
    # the copy at step 2 took the critic after two updates, not the final one
    assert max(float((a - b).abs().max()) for a, b in zip(mods[2].state_dict().values(),
                                                          mods[3].state_dict().values())) > 1e-6
    for key, module in zip(("wm", "actor", "critic"), mods):
        adam_diff(getattr(optimizers, key).optimizer, module, s2[key], MOMENT_RTOL, key)
    assert optimizers.step == int(s2["step"]) == G


@pytest.mark.parametrize("continuous", [False, True])
def test_player_step_with_exploration_matches_jax(continuous):
    over = ["algo.actor.expl_amount=0.4", "algo.actor.expl_decay=10", "algo.actor.expl_min=0.05"]
    jcfg, tcfg, (wm, actor, _), params, (twm, tactor, _, _) = agents("dreamer_v2", over, continuous)
    n = 4
    _, j_step, j_expl = jdv2.make_player(wm, actor, jcfg, actions_dim(continuous), continuous, n)
    t_init, t_step, t_expl = tdv2.make_player(twm, tactor, tcfg, actions_dim(continuous), continuous, n)
    assert t_expl(15) == pytest.approx(j_expl(15)) and t_expl(10_000) == pytest.approx(0.05)
    rng = np.random.default_rng(9)
    jstate = tuple(jnp.asarray(rng.standard_normal(s).astype(np.float32)) for s in ((n, 16), (n, 16), (n, sum(actions_dim(continuous)))))
    tstate = tuple(torch.from_numpy(np.array(x)) for x in jstate)
    key = jax.random.PRNGKey(10)
    for _ in range(2):
        obs = obs_batch(rng, (n,))
        env_a, a, jstate, next_key = j_step({"wm": params["wm"], "actor": params["actor"]}, obs, jstate, key,
                                            expl_amount=j_expl(15))
        t_env, t_a, tstate = t_step(obs, tstate, noise=jax_player_noise(key, tcfg, continuous, n),
                                    expl_amount=t_expl(15))
        key = next_key
        np.testing.assert_allclose(t_a.numpy(), np.asarray(a), rtol=0, atol=FWD_ATOL)
        if continuous:
            np.testing.assert_allclose(t_env.numpy(), np.asarray(env_a), rtol=0, atol=FWD_ATOL)
        else:
            np.testing.assert_array_equal(t_env.numpy(), np.asarray(env_a))
        for got, want in zip(tstate, jstate):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    reset = t_init(np.array([True, False, True, False]), tstate)
    assert float(reset[0][0].abs().max()) == 0.0 and torch.equal(reset[0][1], tstate[0][1])


@pytest.mark.parametrize("momentum,centered", [(0.0, False), (0.9, True)])
def test_rmsprop_tf_matches_the_jax_package(momentum, centered):
    """Four steps from the same weights and gradients; then the converter
    loads the JAX state into a fresh optimizer."""
    rng = np.random.default_rng(11)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    tx = jax_rmsprop_tf(lr=1e-2, alpha=0.9, eps=1e-6, momentum=momentum, centered=centered)
    p = {"w": jnp.asarray(w0)}
    s = tx.init(p)
    holder = torch.nn.Module()
    holder.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = rmsprop_tf(holder.parameters(), lr=1e-2, alpha=0.9, eps=1e-6, momentum=momentum, centered=centered)
    assert isinstance(opt, RMSpropTF)
    for _ in range(4):
        g = rng.standard_normal((5, 3)).astype(np.float32)
        u, s = tx.update({"w": jnp.asarray(g)}, s, p)
        p = optax.apply_updates(p, u)
        holder.w.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(holder.w.detach().numpy(), np.asarray(p["w"]), rtol=1e-6, atol=1e-6)
    fresh = rmsprop_tf(holder.parameters(), momentum=momentum, centered=centered)
    convert.load_optimizer_state(fresh, holder, s)
    for name in ("square_avg", "momentum_buffer", "grad_avg"):
        assert (name in opt.state[holder.w]) == (name in fresh.state[holder.w]), name
        if name in opt.state[holder.w]:
            np.testing.assert_allclose(opt.state[holder.w][name].numpy(), fresh.state[holder.w][name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("exp", ["dreamer_v2", "dreamer_v2_benchmarks", "dreamer_v2_ms_pacman", "dreamer_v1",
                                 "dreamer_v1_benchmarks"])
def test_presets_compose_to_the_jax_packages_algo(exp):
    jcfg, tcfg = configs(exp)
    within(tcfg.algo.to_dict(), jcfg.algo.to_dict())
    for k in ("type", "prioritize_ends", "size"):
        if jcfg.select(f"buffer.{k}") is not None:
            assert tcfg.select(f"buffer.{k}") == jcfg.select(f"buffer.{k}"), k
    assert tcfg.select("distribution.type") == jcfg.select("distribution.type")


def test_optim_rmsprop_tf_is_selectable():
    _, tcfg = configs("dreamer_v2", ["optim@algo.actor.optimizer=rmsprop_tf"])
    assert tcfg.algo.actor.optimizer["_target_"] == "sheeprl_tpu_torch.optim.rmsprop_tf"


RUN = ["exp=dreamer_v2", "env=dummy", "fabric.accelerator=cpu", "algo.dense_units=8", "algo.mlp_layers=1",
       "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=16",
       "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
       "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "algo.per_rank_sequence_length=2",
       "algo.per_rank_batch_size=2", "algo.horizon=3", "buffer.memmap=False"]


def last_checkpoint(run: str, env: str = "*"):
    paths = sorted(glob.glob(f"logs/runs/dreamer_v2/{env}/{run}/version_*/checkpoint/*.ckpt"),
                   key=lambda p: int(p[:-5].split("_")[-1]))
    return paths[-1]


@pytest.mark.parametrize("extra", [["run_name=seq"],
                                   ["run_name=ep", "env.id=continuous_dummy", "buffer.type=episode",
                                    "buffer.prioritize_ends=True", "buffer.memmap=True"]])
def test_cli_dry_run_and_eval_on_cpu(extra, capsys):
    cli.run(RUN + ["dry_run=True", *extra])
    out = capsys.readouterr()
    assert "[dreamer_v2] log_dir=" in out.out and "Test - Reward:" in out.out and "StagedPrefetcher" in out.err
    ckpt = last_checkpoint(extra[0].split("=")[1])
    state = torch.load(ckpt, weights_only=False)
    assert state["policy_step"] == 4 and state["opt_states"]["step"] > 0
    assert ("episodes" in state["rb"]) == ("buffer.type=episode" in extra)
    cli.evaluation([f"checkpoint_path={ckpt}"])
    assert "Test - Reward:" in capsys.readouterr().out


def test_cli_resume_carries_the_step_counter(capsys):
    args = RUN + ["algo.learning_starts=8", "algo.total_steps=16", "buffer.size=64", "checkpoint.every=8",
                  "algo.run_test=False", "algo.critic.per_rank_target_network_update_freq=3"]
    cli.run(args + ["run_name=one"])
    state = torch.load(last_checkpoint("one"), weights_only=False)
    assert state["policy_step"] == 16 and state["opt_states"]["step"] == state["grad_steps"] > 0
    capsys.readouterr()
    cli.resume(["run_dir=logs/runs/dreamer_v2/discrete_dummy/one", "algo.total_steps=24"])
    out = capsys.readouterr().out
    started = [line for line in out.splitlines() if line.startswith("[dreamer_v2] resumed ")]
    assert started and '"policy_step": 16' in started[0]
    resumed = torch.load(last_checkpoint("one"), weights_only=False)
    assert resumed["policy_step"] == 24 and resumed["opt_states"]["step"] > state["opt_states"]["step"]


def test_fleet_mode_is_refused():
    with pytest.raises(NotImplementedError, match="dreamer_v2 has no fleet program"):
        cli.run(RUN + ["run_name=fleet", "algo.fleet.workers=1"])
