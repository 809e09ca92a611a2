"""A2C in the PyTorch port against the JAX package, on the CPU.

* the port's ``RMSprop`` against ``optax.rmsprop`` (eps 1e-4, as
  ``exp=a2c``, optax 0.2.6's default ``eps_in_sqrt=True``) over several
  steps, plain, with momentum and centered; and ``torch.optim.RMSprop``
  (``1 / (sqrt(ν) + eps)``) shown to miss optax at the same tolerance, so
  the trap stays covered;
* the two losses;
* one update (the whole rollout, one clipped RMSprop step) from the same
  parameters and RMSprop ``ν`` (taken after one JAX update);
* A2C's agent refuses pixel keys; a CPU dry run of the CLI and ``eval``.

Tolerances: RMSprop parameters rel 1e-5 after 5 steps (measured: 8.5e-8;
``torch.optim.RMSprop`` is off by 8.1e-3, rel 0.19, after the first);
losses rel 1e-5 (measured: 2.1e-7); the update's metrics rel 1e-4
(measured: 4.8e-7) and parameters atol 1e-5 (measured: 6.0e-8).
The measured values: ``python scripts/onpolicy_parity_report.py``.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.a2c import loss as jloss
from sheeprl_tpu.algos.a2c.a2c import make_update_fn as jax_make_update_fn
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.optim import clipped as jax_clipped
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.a2c import loss as tloss
from sheeprl_tpu_torch.algos.a2c.a2c import make_update_fn as torch_make_update_fn
from sheeprl_tpu_torch.algos.a2c.agent import build_agent
from sheeprl_tpu_torch.config import instantiate as torch_instantiate
from sheeprl_tpu_torch.optim import RMSprop, clipped as torch_clipped
from torch_onpolicy import (agents, assert_params_close, configs, last_checkpoint, numpy_tree, obs_space, rollout_data,
                            to_torch)

RMS_RTOL = 1e-5
METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-5


def _rmsprop_runs(make_torch, steps=5, lr=1e-3, eps=1e-4, **kw):
    """The parameters after ``steps`` updates with the same gradients: optax
    rmsprop's and the torch optimizer ``make_torch`` builds."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [(rng.standard_normal((4, 3)) * 10 ** rng.uniform(-3, 0)).astype(np.float32) for _ in range(steps)]
    tx = optax.rmsprop(lr, decay=0.99, eps=eps, momentum=kw.get("momentum") or None, centered=kw.get("centered", False))
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_torch([tp], lr=lr, alpha=0.99, eps=eps, **kw)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    return tp.detach().numpy(), np.asarray(jp), p0


@pytest.mark.parametrize("kw", [{}, {"momentum": 0.9}, {"centered": True}], ids=["plain", "momentum", "centered"])
def test_rmsprop_matches_optax(kw):
    got, want, p0 = _rmsprop_runs(RMSprop, **kw)
    assert not np.allclose(want, p0)
    np.testing.assert_allclose(got, want, rtol=RMS_RTOL, atol=1e-7)


def test_torch_rmsprop_misses_optax_at_a2c_eps():
    """The eps_in_sqrt trap: torch.optim.RMSprop divides by sqrt(ν) + eps."""
    got, want, _ = _rmsprop_runs(torch.optim.RMSprop, steps=1)
    assert not np.allclose(got, want, rtol=RMS_RTOL, atol=1e-7)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_losses_match_jax(reduction):
    rng = np.random.default_rng(1)
    lp, adv, v, ret = (rng.standard_normal((20, 1)).astype(np.float32) for _ in range(4))
    pairs = [(jloss.policy_loss(jnp.asarray(lp), jnp.asarray(adv), reduction),
              tloss.policy_loss(torch.from_numpy(lp), torch.from_numpy(adv), reduction)),
             (jloss.value_loss(jnp.asarray(v), jnp.asarray(ret), reduction),
              tloss.value_loss(torch.from_numpy(v), torch.from_numpy(ret), reduction))]
    for a, b in pairs:
        np.testing.assert_allclose(float(b), float(a), rtol=RMS_RTOL)


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_update_matches_jax(continuous):
    """One A2C update from the same parameters and RMSprop ν (after a first
    JAX update), the max_grad_norm of exp=a2c (0.5) clipping."""
    jcfg, tcfg = configs("a2c")
    adim = [2] if continuous else [3]
    jm, params, ta = agents(False, adim, continuous)
    tx = jax_clipped(jax_instantiate(jcfg.algo.optimizer), jcfg.algo.get("max_grad_norm", 0.0))
    j_update = jax_make_update_fn(jm, tx, jcfg)
    rng = np.random.default_rng(2)
    warm = {k: jnp.asarray(v) for k, v in rollout_data(rng, 20, adim, continuous, False).items()}
    p1, s1, _ = j_update(jax.tree.map(jnp.array, params), tx.init(params), warm)
    p1, s1 = numpy_tree(p1), numpy_tree(s1)
    opt = torch_clipped(torch_instantiate(tcfg.algo.optimizer, list(ta.parameters())), tcfg.algo.max_grad_norm)
    assert isinstance(opt.optimizer, RMSprop)
    convert.load_a2c(p1, ta, s1, opt)
    data = rollout_data(rng, 20, adim, continuous, False)
    p2, _, j_metrics = j_update(jax.tree.map(jnp.array, p1), s1, {k: jnp.asarray(v) for k, v in data.items()})
    t_metrics = torch_make_update_fn(ta, opt, tcfg)(to_torch(data))
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(t_metrics[k]), float(v), rtol=METRIC_RTOL, err_msg=k)
    assert_params_close(ta, convert.params_to_state_dict(numpy_tree(p2), ta), PARAM_ATOL)


def test_agent_refuses_pixel_keys():
    _, tcfg = configs("a2c", ["algo.cnn_keys.encoder=[rgb]"])
    from sheeprl_tpu_torch.envs import spaces

    with pytest.raises(ValueError, match="vector observations"):
        build_agent(tcfg, obs_space(True), spaces.Discrete(2), torch.device("cpu"))


def test_cli_dry_run_and_eval_on_cpu(capsys):
    cli.run(["exp=a2c", "env=dummy", "fabric.accelerator=cpu", "dry_run=True", "env.num_envs=2",
             "buffer.memmap=False", "run_name=dry"])
    out = capsys.readouterr().out
    assert "[a2c] log_dir=" in out and "Test - Reward:" in out
    from pathlib import Path

    ckpt = sorted(Path("logs/runs/a2c").glob("*/dry/version_0/checkpoint/ckpt_*.ckpt"))[-1]
    assert last_checkpoint("dry", "a2c")["update"] == 1
    cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    assert "Test - Reward:" in capsys.readouterr().out
