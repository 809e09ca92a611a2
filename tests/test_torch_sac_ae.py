"""SAC-AE in the PyTorch port against the JAX package, on the CPU, at
multiplier 1 (32 channels) on 64x64 frames, so the decoder's 63→64 padding
runs, with an image key and a vector key (both encoder and decoder
branches).

* the encoder and the decoder forward from converted parameters, under
  ``conv_impl=einsum`` (the JAX package's CPU lowering) and ``xla``: the
  decoder's ``ConvTranspose`` with ``transpose_kernel=False`` converts to
  ``ConvTranspose2d`` flipped in space, and the padding row is zeros after
  the bias;
* ``preprocess_obs`` with the JAX dither;
* the masked update: on a step where an update is not due, optax runs on
  zeroed gradients and the update is zeroed; the port's Adam (and the
  decoder's AdamW) state advances the same way while the parameters stay
  bitwise unchanged;
* one burst of G = 3 gradient steps of ``make_train_fn`` from the same
  parameters and Adam states (after a first JAX burst), with the JAX step's
  draws (``split(key)`` for the next action, ``fold_in(key, 1)`` for the
  actor, ``fold_in(key, 2 + i)`` for image key i's dither), the actor and
  the targets due every second step and the decoder every step or every
  second: the losses, every parameter, both targets, ``log_alpha``, the
  five Adam states and the step counter; under both ``conv_impl`` values;
* CLI runs on the CPU at cut widths: a dry run, a short run and ``eval``.

Tolerances: forwards atol 1e-5 (measured: 2.3e-6); the dither target exact;
the masked steps' moments rel 1e-6 (measured: 0.0), the parameters bitwise
unchanged by a step that is not due and atol 1e-6 of optax's after the two
due steps (measured: 2.4e-7). The burst's losses rel 1e-4 and log_alpha atol
2e-5 (measured: 1.7e-5 rel, 2.5e-5 abs of losses near 4). Its parameters:
atol 2e-5, but for at most 5% of a tensor's elements, which must be within
G·lr = 3e-3 (measured: 0.87% of the decoder's fc kernel, at most 9.6e-4;
3.3e-5 at most under xla). Why: one step from the same state matches to
2e-6; over a burst, a unit sitting at a ReLU's zero in one implementation
and just above it in the other gives its weights a gradient of rounding size
on one side only, which Adam scales to a step of about lr; the decoder's
gradients are the step's smallest (the reconstruction averages 64·64·3
pixels, |g| <= 8e-5), so Adam's normalisation spreads that drift into its
moments: the decoder's Adam moments rel 5e-2 of each tensor's largest
(measured: 1.9e-2), the other optimizers' rel 1e-4. The measured values:
``PYTHONPATH=. python tests/torch_offpolicy.py``.
"""
import torch_threads
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.sac_ae import agent as jagent
from sheeprl_tpu.algos.sac_ae import utils as jutils
from sheeprl_tpu.algos.sac_ae.sac_ae import make_train_fn as jax_make_train_fn
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.optim import adam as jax_adam
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.sac.sac import apply_grads
from sheeprl_tpu_torch.algos.sac_ae import agent as tagent
from sheeprl_tpu_torch.algos.sac_ae import utils as tutils
from sheeprl_tpu_torch.algos.sac_ae.sac_ae import build_optimizers
from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_train_fn as torch_make_train_fn
from sheeprl_tpu_torch.optim import adam as torch_adam
from torch_offpolicy import (ACT, IMG, STATE, adam_diff, assert_losses, configs, dist, jax_spaces, max_diff,
                             numpy_tree, replay_batch, t, to_jax, to_torch, torch_spaces)

FWD_ATOL = 1e-5
BURST_RTOL = 1e-4
PARAM_ATOL = 2e-5
MOMENT_RTOL = 1e-4
DECODER_MOMENT_RTOL = 5e-2
OUTLIER_SHARE = 0.05
WIDTHS = ["algo.cnn_channels_multiplier=1", "algo.hidden_size=32", "algo.encoder.features_dim=16",
          "algo.dense_units=16", "algo.per_rank_batch_size=4", "env.num_envs=2", "algo.mlp_keys.encoder=[state]"]
OPTS = ("qf", "actor", "alpha", "encoder", "decoder")


def agents(conv_impl: str, overrides=()):
    jcfg, tcfg = configs("sac_ae", [*WIDTHS, *overrides])
    jcfg.algo.conv_impl = conv_impl
    jo, ja = jax_spaces(pixels=True)
    encoder, decoder, qs, actor, params = jagent.build_agent(dist(), jcfg, jo, ja, jax.random.PRNGKey(0))
    params = numpy_tree(params)
    to, ta = torch_spaces(pixels=True)
    agent = tagent.build_agent(tcfg, to, ta)
    convert.load_sac_ae(params, agent)
    return jcfg, tcfg, (encoder, decoder, qs, actor), params, agent


def obs_batch(rng, batch):
    return {"rgb": rng.integers(0, 256, (batch, *IMG), dtype=np.uint8).astype(np.float32) / 255.0,
            "state": rng.standard_normal((batch, STATE)).astype(np.float32)}


@pytest.mark.parametrize("conv_impl", ["einsum", "xla"])
def test_encoder_and_decoder_forward_match_flax(conv_impl):
    _, _, (encoder, decoder, _, _), params, agent = agents(conv_impl)
    obs = obs_batch(np.random.default_rng(1), 3)
    j_feat = encoder.apply({"params": params["encoder"]}, to_jax(obs))
    j_rec = decoder.apply({"params": params["decoder"]}, j_feat)
    with torch.no_grad():
        t_feat = agent.encoder(to_torch(obs))
        t_rec = agent.decoder(t(j_feat))
    assert t_feat.shape == (3, 32) and t_rec["rgb"].shape == (3, 64, 64, 3) and t_rec["state"].shape == (3, STATE)
    np.testing.assert_allclose(t_feat.numpy(), np.asarray(j_feat), rtol=0, atol=FWD_ATOL)
    for k in ("rgb", "state"):
        np.testing.assert_allclose(t_rec[k].numpy(), np.asarray(j_rec[k]), rtol=0, atol=FWD_ATOL, err_msg=k)
    # the padding row and column: zeros, not the bias
    assert float(t_rec["rgb"][:, 63].abs().max()) == 0.0 and float(t_rec["rgb"][:, :, 63].abs().max()) == 0.0


def test_decoder_conversion_flips_the_kernel_in_space():
    """With a non-zero bias and an asymmetric kernel: converted without the
    flip, the transposed convolutions would not match."""
    _, _, (_, decoder, _, _), params, agent = agents("xla")
    rng = np.random.default_rng(2)
    dec = jax.tree.map(lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32), params["decoder"])
    convert.load_params(dec, agent.decoder)
    feat = rng.standard_normal((2, 32)).astype(np.float32)
    j_rec = decoder.apply({"params": dec}, jnp.asarray(feat))
    with torch.no_grad():
        t_rec = agent.decoder(t(feat))
    np.testing.assert_allclose(t_rec["rgb"].numpy(), np.asarray(j_rec["rgb"]), rtol=0, atol=FWD_ATOL)
    assert float(t_rec["rgb"][:, 63].abs().max()) == 0.0 and float(t_rec["rgb"][:, :62].abs().max()) > 0.0
    unflipped = dec["SACAECNNDecoder_0"]["to_obs"]["kernel"].transpose(2, 3, 0, 1)
    with torch.no_grad():
        agent.decoder.SACAECNNDecoder_0.to_obs.weight.copy_(torch.from_numpy(np.ascontiguousarray(unflipped)))
        wrong = agent.decoder(t(feat))["rgb"]
    assert float((wrong - t_rec["rgb"]).abs().max()) > 1e-3


def test_preprocess_obs_with_the_jax_dither():
    rng = np.random.default_rng(3)
    obs = rng.integers(0, 256, (4, *IMG), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    want = jutils.preprocess_obs(jnp.asarray(obs), bits=5, key=key)
    got = tutils.preprocess_obs(torch.from_numpy(obs), 5, t(jax.random.uniform(key, obs.shape)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tutils.preprocess_obs(torch.from_numpy(obs), 5).numpy(),
                                  np.asarray(jutils.preprocess_obs(jnp.asarray(obs), bits=5)))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_masked_update_advances_the_state_and_keeps_the_parameters(weight_decay):
    """Two due steps, then two that are not: optax (zeroed gradients, zeroed
    update) and the port's step leave the parameters bitwise where they
    were and advance the count and moments alike."""
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(4)]
    tx = jax_adam(lr=1e-3, eps=1e-8, weight_decay=weight_decay)
    p, s = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch_adam([w], lr=1e-3, eps=1e-8, weight_decay=weight_decay)
    assert isinstance(opt, torch.optim.AdamW if weight_decay else torch.optim.Adam)
    for i, g in enumerate(grads):
        due = i < 2
        gj = jnp.where(due, jnp.asarray(g), 0.0)
        u, s = tx.update(gj, s, p)
        p = optax.apply_updates(p, jnp.where(due, u, 0.0))
        before = w.detach().clone()
        apply_grads(opt, [w], [torch.from_numpy(g)], apply=due)
        if not due:
            assert torch.equal(w.detach(), before)
    adam = convert.find_state(s)
    st = opt.state[w]
    assert int(st["step"]) == int(adam.count) == 4
    np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam.mu), rtol=1e-6)
    np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam.nu), rtol=1e-6)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p), rtol=0, atol=1e-6)


def jax_train_fn(jcfg, mods):
    """The JAX package's optimizers and its jitted train step."""
    encoder, decoder, qs, actor = mods
    txs = {"actor": jax_instantiate(jcfg.algo.actor.optimizer), "qf": jax_instantiate(jcfg.algo.critic.optimizer),
           "alpha": jax_instantiate(jcfg.algo.alpha.optimizer),
           "encoder": jax_instantiate(jcfg.algo.encoder.optimizer),
           "decoder": jax_instantiate(jcfg.algo.decoder.optimizer)}
    return txs, jax_make_train_fn(encoder, decoder, qs, actor, txs, jcfg, -float(ACT), ("rgb",), ("state",))


def jax_burst(jcfg, mods, params, opt_states, batches, keys, train=None):
    """One JAX burst; ``train`` (``jax_train_fn``'s) lets bursts of the same
    shapes share one compile."""
    txs, own = jax_train_fn(jcfg, mods)
    train = train or own
    if opt_states is None:
        opt_states = {"actor": txs["actor"].init(params["actor"]),
                      "qf": txs["qf"].init({"encoder": params["encoder"], "qs": params["qs"]}),
                      "alpha": txs["alpha"].init(params["log_alpha"]),
                      "encoder": txs["encoder"].init(params["encoder"]),
                      "decoder": txs["decoder"].init(params["decoder"]), "step": jnp.zeros((), jnp.int32)}
    p, s, m = train(jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, opt_states), to_jax(batches), keys)
    return numpy_tree(p), numpy_tree(s), m


def jax_draws(keys, batch):
    out = []
    for k in keys:
        k, k_next = jax.random.split(k)
        out.append({"next": t(jax.random.normal(k_next, (batch, ACT))),
                    "actor": t(jax.random.normal(jax.random.fold_in(k, 1), (batch, ACT))),
                    "dither": [t(jax.random.uniform(jax.random.fold_in(k, 2), (batch, *IMG)))]})
    return out


@pytest.mark.parametrize("conv_impl,decoder_every", [("einsum", 1), ("xla", 2)])
def test_train_burst_matches_jax(conv_impl, decoder_every):
    jcfg, tcfg, mods, params, agent = agents(conv_impl, [f"algo.decoder.per_rank_update_freq={decoder_every}"])
    G, B = 3, 4
    rng = np.random.default_rng(5)
    spec = {"rgb": IMG, "state": (STATE,)}
    p1, s1, _ = jax_burst(jcfg, mods, params, None, replay_batch(rng, (1, B), spec, vector_obs=False),
                          jax.random.split(jax.random.PRNGKey(1), 1))
    batches = replay_batch(rng, (G, B), spec, vector_obs=False)
    keys = jax.random.split(jax.random.PRNGKey(2), G)
    p2, s2, j_metrics = jax_burst(jcfg, mods, p1, s1, batches, keys)
    optimizers = build_optimizers(tcfg, agent)
    convert.load_sac_ae(p1, agent, s1, optimizers)
    assert optimizers.step == 1
    train = torch_make_train_fn(agent, optimizers, tcfg, -float(ACT), ("rgb",), ("state",))
    with torch_threads.default_threads():  # held at the default count (ROADMAP Queue 3 item 15)
        t_metrics = train(to_torch(batches), draws=jax_draws(keys, B))
    assert_losses(t_metrics, j_metrics, BURST_RTOL)
    for key in ("encoder", "qs", "actor", "decoder", "target_encoder", "target_qs"):
        max_diff(getattr(agent, key), p2[key], PARAM_ATOL, key, outliers=(OUTLIER_SHARE, G * 1e-3))
    np.testing.assert_allclose(float(agent.log_alpha.detach()), float(p2["log_alpha"]), rtol=0, atol=PARAM_ATOL)
    modules = {"qf": torch.nn.ModuleDict({"encoder": agent.encoder, "qs": agent.qs}), "actor": agent.actor,
               "encoder": agent.encoder, "decoder": agent.decoder}
    for name, module in modules.items():
        adam_diff(optimizers[name], module, s2[name], DECODER_MOMENT_RTOL if name == "decoder" else MOMENT_RTOL,
                  name)
    st, adam = optimizers["alpha"].state[agent.log_alpha], convert.find_state(s2["alpha"])
    assert int(st["step"]) == int(adam.count) == 4
    np.testing.assert_allclose(float(st["exp_avg"]), float(adam.mu), rtol=MOMENT_RTOL)
    assert optimizers.step == int(s2["step"]) == 4


RUN = ["exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "env.num_envs=2",
       "algo.cnn_channels_multiplier=1", "algo.hidden_size=32", "algo.per_rank_batch_size=8", "buffer.memmap=False"]


def test_cli_dry_run_short_run_and_eval_on_cpu(capsys):
    cli.run(RUN + ["dry_run=True", "run_name=dry"])
    out = capsys.readouterr().out
    assert "[sac_ae] log_dir=" in out and "Test - Reward:" in out
    cli.run(RUN + ["algo.total_steps=24", "algo.learning_starts=16", "buffer.size=32", "algo.run_test=False",
                   "checkpoint.every=0", "run_name=short"])
    ckpt = sorted(glob.glob("logs/runs/sac_ae/*/short/version_0/checkpoint/*.ckpt"))[-1]
    state = torch.load(ckpt, weights_only=False)
    assert state["policy_step"] == 24 and state["opt_states"]["step"] == 8
    assert state["rb"]["buffer"]["next_rgb"].dtype == np.uint8
    capsys.readouterr()
    cli.evaluation([f"checkpoint_path={ckpt}"])
    assert "Test - Reward:" in capsys.readouterr().out
