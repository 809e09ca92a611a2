"""Recurrent PPO in the PyTorch port against the JAX package, on the CPU.

* the LSTM conversion: flax's ``OptimizedLSTMCell`` (separate ``i, f, g, o``
  kernels, hidden biases, carry ``(c, h)``) folded into ``nn.LSTMCell``
  (``weight_ih``/``weight_hh`` stacked i, f, g, o, ``bias_hh``, a frozen zero
  ``bias_ih``), and one ``ResetLSTMCell`` step against flax's with resets;
* the reset on ``is_first`` inside the sequence: a reset mid-sequence gives
  what a fresh sequence from a zero carry gives;
* ``to_seq``: sequence ``s = chunk*N + env`` holds ``x[chunk*L + l, env]``;
* the agent over sequences (pre- and post-RNN MLPs on, discrete and
  continuous) and one whole update (2 epochs × 2 minibatches of sequences,
  the JAX permutations, Adam state after one JAX update) against the JAX
  package's;
* a CPU dry run of the CLI and ``eval``.

Tolerances: the LSTM step and the agent's outputs atol 1e-5 (measured:
3.9e-7); the update's metrics rel 1e-4 (measured: 5.1e-7) and parameters
atol 1e-5 (measured: 1.2e-7); the reset against a fresh sequence atol 1e-6.
The measured values: ``python scripts/onpolicy_parity_report.py``.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo_recurrent import agent as jagent
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import make_update_fn as jax_make_update_fn
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.optim import clipped as jax_clipped
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.ppo_recurrent import agent as tagent
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_update_fn as torch_make_update_fn
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import to_seq
from sheeprl_tpu_torch.config import instantiate as torch_instantiate
from sheeprl_tpu_torch.optim import clipped as torch_clipped
from torch_onpolicy import (assert_params_close, configs, jax_coefs, jax_perms, last_checkpoint, numpy_tree,
                            obs_batch, obs_space, rollout_data, to_torch, torch_coefs)

ATOL = 1e-5
METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-5
H = 16
WIDTHS = dict(mlp_features_dim=16, encoder_dense_units=16, encoder_mlp_layers=1, lstm_hidden_size=H,
              pre_rnn_dense_units=16, post_rnn_dense_units=16, actor_dense_units=16, critic_dense_units=16)


def rec_agents(actions_dim, continuous: bool, pre_post: bool = True, seed: int = 0):
    kw = dict(WIDTHS, pre_rnn_apply=pre_post, post_rnn_apply=pre_post)
    jm = jagent.RecurrentPPOAgent(actions_dim=tuple(actions_dim), is_continuous=continuous, mlp_keys=("state",), **kw)
    obs = {k: jnp.asarray(v) for k, v in obs_batch(np.random.default_rng(0), (1, 1), False).items()}
    params = numpy_tree(jm.init(jax.random.PRNGKey(seed), obs, jnp.zeros((1, 1, sum(actions_dim))),
                                jnp.zeros((1, 1, 1)), jm.initial_states(1))["params"])
    ta = tagent.RecurrentPPOAgent(obs_space(False), actions_dim, continuous, mlp_keys=("state",), **kw)
    convert.load_ppo_recurrent(params, ta)
    return jm, params, ta


def test_lstm_conversion_and_one_step_match_flax():
    rng = np.random.default_rng(1)
    B, F = 5, 7
    cell = jagent.ResetLSTMCell(H)
    x = rng.standard_normal((B, F)).astype(np.float32)
    carry = tuple(rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    first = np.array([[0.0], [1.0], [0.0], [1.0], [0.0]], np.float32)
    params = numpy_tree(cell.init(jax.random.PRNGKey(3), carry, (x, first))["params"])
    # the flax cell's hidden biases are zero at init: give them values
    for g in "ifgo":
        params["lstm"][f"h{g}"]["bias"] = rng.standard_normal(H).astype(np.float32)
    (jc, jh), jy = cell.apply({"params": params}, carry, (jnp.asarray(x), jnp.asarray(first)))
    tc = tagent.ResetLSTMCell(F, H)
    convert.load_params(params, tc)
    assert not tc.lstm.bias_ih.requires_grad and float(tc.lstm.bias_ih.abs().sum()) == 0.0
    with torch.no_grad():
        c, h = tc(tuple(torch.from_numpy(v) for v in carry), torch.from_numpy(x), torch.from_numpy(first))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jy), rtol=0, atol=ATOL)


def test_reset_on_is_first_inside_the_sequence():
    _, _, ta = rec_agents([3], False)
    rng = np.random.default_rng(2)
    L, B = 6, 3
    obs = to_torch(obs_batch(rng, (L, B), False))
    prev = torch.from_numpy(rng.standard_normal((L, B, 3)).astype(np.float32))
    first = torch.zeros(L, B, 1)
    first[3, 1] = 1.0
    carry = tuple(torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        out, v, _ = ta(obs, prev, first, carry)
        fresh_out, fresh_v, _ = ta({k: o[3:, 1:2] for k, o in obs.items()}, prev[3:, 1:2], torch.zeros(L - 3, 1, 1),
                                   ta.initial_states(1))
    torch.testing.assert_close(v[3:, 1:2], fresh_v, rtol=0, atol=1e-6)
    torch.testing.assert_close(out[0][3:, 1:2], fresh_out[0], rtol=0, atol=1e-6)
    assert not torch.allclose(v[:3, 1:2], v[3:, 1:2][:3])  # the carry did matter before the reset


def test_to_seq_orders_sequences_chunk_major():
    T, N, L = 8, 3, 4
    x = np.arange(T * N * 2).reshape(T, N, 2)
    s = to_seq(x, L)
    assert s.shape == (T // L * N, L, 2)
    for chunk in range(T // L):
        for env in range(N):
            np.testing.assert_array_equal(s[chunk * N + env], x[chunk * L:(chunk + 1) * L, env])


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_agent_over_sequences_matches_jax(continuous):
    adim = [2] if continuous else [3, 2]
    jm, params, ta = rec_agents(adim, continuous)
    rng = np.random.default_rng(3)
    L, B = 5, 4
    obs = obs_batch(rng, (L, B), False)
    prev = rng.standard_normal((L, B, sum(adim))).astype(np.float32)
    first = (rng.random((L, B, 1)) < 0.3).astype(np.float32)
    carry = tuple(rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    j_out, j_v, (j_c, j_h) = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in obs.items()},
                                      jnp.asarray(prev), jnp.asarray(first), tuple(jnp.asarray(c) for c in carry))
    with torch.no_grad():
        t_out, t_v, (t_c, t_h) = ta(to_torch(obs), torch.from_numpy(prev), torch.from_numpy(first),
                                    tuple(torch.from_numpy(c) for c in carry))
    for a, b in zip(list(t_out) + [t_v, t_c, t_h], list(j_out) + [j_v, j_c, j_h]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_update_matches_jax(continuous):
    """One whole update (2 epochs × 2 minibatches of 4 sequences of 4 steps)
    from the same parameters and Adam state, the JAX permutations over
    sequences, exp=ppo_recurrent's losses and clipping."""
    jcfg, tcfg = configs("ppo_recurrent", ["algo.update_epochs=2", "algo.normalize_advantages=True"])
    adim = [2] if continuous else [3]
    jm, params, ta = rec_agents(adim, continuous)
    S, L, mb = 8, 4, 4
    tx = jax_clipped(jax_instantiate(jcfg.algo.optimizer), jcfg.algo.get("max_grad_norm", 0.0))
    j_update = jax_make_update_fn(jm, tx, jcfg, S // mb, mb)
    rng = np.random.default_rng(4)
    coefs = dict(clip_coef=0.2, ent_coef=0.001, vf_coef=0.2, lr_frac=1.0)

    def batch():
        d = rollout_data(rng, L, adim, continuous, False, lead=(S,))
        d["prev_actions"] = rng.standard_normal((S, L, sum(adim))).astype(np.float32)
        d["is_first"] = (rng.random((S, L, 1)) < 0.25).astype(np.float32)
        d["cx0"], d["hx0"] = (rng.standard_normal((S, H)).astype(np.float32) for _ in range(2))
        return d

    warm = {k: jnp.asarray(v) for k, v in batch().items()}
    p1, s1, _ = j_update(jax.tree.map(jnp.array, params), tx.init(params), warm, jax_coefs(coefs),
                         jax.random.PRNGKey(1))
    p1, s1 = numpy_tree(p1), numpy_tree(s1)
    opt = torch_clipped(torch_instantiate(tcfg.algo.optimizer, [p for p in ta.parameters() if p.requires_grad]),
                        tcfg.algo.max_grad_norm)
    convert.load_ppo_recurrent(p1, ta, s1, opt)
    data = batch()
    key = jax.random.PRNGKey(2)
    p2, _, j_metrics = j_update(jax.tree.map(jnp.array, p1), s1, {k: jnp.asarray(v) for k, v in data.items()},
                                jax_coefs(coefs), key)
    perms = torch.from_numpy(jax_perms(key, 2, S).astype(np.int64))
    t_metrics = torch_make_update_fn(ta, opt, tcfg, S // mb, mb)(to_torch(data), torch_coefs(coefs), perms)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(t_metrics[k]), float(v), rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    assert_params_close(ta, convert.params_to_state_dict(numpy_tree(p2), ta), PARAM_ATOL)


def test_cli_dry_run_and_eval_on_cpu(capsys):
    cli.run(["exp=ppo_recurrent", "env=dummy", "fabric.accelerator=cpu", "dry_run=True", "env.num_envs=2",
             "algo.rollout_steps=32", "algo.per_rank_sequence_length=8", "env.max_episode_steps=3", "run_name=dry"])
    out = capsys.readouterr().out
    assert "[ppo_recurrent] log_dir=" in out and "Test - Reward:" in out
    from pathlib import Path

    ckpt = sorted(Path("logs/runs/ppo_recurrent").glob("*/dry/version_0/checkpoint/ckpt_*.ckpt"))[-1]
    assert last_checkpoint("dry", "ppo_recurrent")["update"] == 1
    cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    assert "Test - Reward:" in capsys.readouterr().out
