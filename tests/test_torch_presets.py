"""The reference's presets that the port lacked, held against the JAX
package's:

* each composes in the port to the JAX package's ``algo``, ``buffer`` and
  ``env`` (restricted to the keys the port reads, its optimizer targets for
  the JAX package's, its env adapters for the JAX package's), and to its
  ``seed`` and ``checkpoint``: the DIAMBRA, Crafter, MineRL, MineDojo and
  Super Mario Bros presets among them (their runs on stand-ins of the
  suites are tests/test_torch_suites.py's); ``exp=default``
  (``run_benchmarks``) and ``logger=tensorboard`` compose beside an
  experiment;
* ``exp=dreamer_v3_100k_ms_pacman`` runs a few steps at tiny widths on the
  dummy env;
* ``optim.sgd`` takes four steps as optax's ``sgd`` does (rtol 1e-6), plain,
  with momentum, with Nesterov and with weight decay;
* ``distribution.validate_args`` is composed and enters
  ``config_fingerprint``."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.optim import sgd as jax_sgd
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.optim import sgd
from sheeprl_tpu_torch.resilience.resume import config_fingerprint
from torch_offpolicy import configs, within

PRESETS = ["dreamer_v3_100k_ms_pacman", "dreamer_v3_100k_boxing", "dreamer_v3_dmc_cartpole_swingup_sparse",
           "dreamer_v3_benchmarks", "ppo_benchmarks", "a2c_benchmarks", "dreamer_v3_L_doapp",
           "dreamer_v3_L_doapp_128px_gray_combo_discrete", "dreamer_v2_crafter", "dreamer_v3_L_navigate",
           "dreamer_v3_XL_crafter", "dreamer_v3_minedojo", "dreamer_v3_super_mario_bros", "ppo_super_mario_bros"]
# env keys of the port's own (its env/default.yaml: velocity masking and the
# in-flight env restarts) that the JAX package's env configs do not hold
PORT_ONLY_ENV = {"mask_velocities", "restart_on_exception", "restart_window", "restart_maxfails", "restart_wait"}
# exp=default sets run_benchmarks alone: beside algo=ppo the keys exp=ppo would set
PPO_MANDATORY = ["algo.total_steps=64", "algo.per_rank_batch_size=16", "buffer.size=64"]


@pytest.mark.parametrize("exp", PRESETS)
def test_presets_compose_to_the_jax_packages(exp):
    jcfg, tcfg = configs(exp)
    within(tcfg.algo.to_dict(), jcfg.algo.to_dict())
    within(tcfg.buffer.to_dict(), jcfg.buffer.to_dict(), "buffer")
    env = {k: v for k, v in tcfg.env.to_dict().items() if k not in PORT_ONLY_ENV}
    within(env, jcfg.env.to_dict(), "env")
    within(tcfg.checkpoint.to_dict(), jcfg.checkpoint.to_dict(), "checkpoint")
    assert tcfg.seed == jcfg.seed


@pytest.mark.parametrize("exp,overrides,key,value", [
    ("default", ["algo=ppo", "env=dummy", *PPO_MANDATORY], "run_benchmarks", False),
    ("ppo", ["logger=tensorboard"], "logger.type", "tensorboard"),
])
def test_exp_default_and_the_tensorboard_logger_compose(exp, overrides, key, value):
    jcfg, tcfg = configs(exp, overrides)
    assert tcfg.select(key) == jcfg.select(key) == value


def test_dreamer_v3_100k_ms_pacman_runs_a_few_steps_on_the_dummy_env():
    cli.run(["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "env.id=discrete_dummy", "fabric.accelerator=cpu",
             "algo=dreamer_v3_XS", "algo.dense_units=8", "algo.world_model.recurrent_model.recurrent_state_size=8",
             "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.per_rank_sequence_length=4",
             "algo.per_rank_batch_size=2", "algo.learning_starts=8", "algo.total_steps=12", "buffer.size=64",
             "buffer.memmap=False", "algo.run_test=False", "run_name=pacman"])
    (ckpt,) = glob.glob("logs/runs/dreamer_v3/discrete_dummy/pacman/version_0/checkpoint/ckpt_12.ckpt")
    state = torch.load(ckpt, weights_only=False)
    assert state["policy_step"] == 12 and state["opt_states"]["step"] > 0
    assert "rb" in state  # the preset's buffer.checkpoint


SGD_CASES = {"plain": dict(momentum=0.0), "momentum": dict(momentum=0.9),
             "nesterov": dict(momentum=0.9, nesterov=True), "weight_decay": dict(momentum=0.9, weight_decay=1e-2)}


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_sgd_matches_the_jax_packages(case):
    kw = SGD_CASES[case]
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    tx = jax_sgd(lr=1e-2, **kw)
    p = {"w": jnp.asarray(w0)}
    s = tx.init(p)
    holder = torch.nn.Module()
    holder.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = sgd(holder.parameters(), lr=1e-2, **kw)
    for _ in range(4):
        g = rng.standard_normal((5, 3)).astype(np.float32)
        u, s = tx.update({"w": jnp.asarray(g)}, s, p)
        p = optax.apply_updates(p, u)
        holder.w.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(holder.w.detach().numpy(), np.asarray(p["w"]), rtol=1e-6)


def test_optim_sgd_is_selectable():
    _, tcfg = configs("ppo", ["optim@algo.optimizer=sgd", "algo.optimizer.momentum=0.9"])
    assert tcfg.algo.optimizer["_target_"] == "sheeprl_tpu_torch.optim.sgd"
    opt = instantiate(tcfg.algo.optimizer, [torch.nn.Parameter(torch.zeros(3))])
    assert isinstance(opt, torch.optim.SGD) and opt.defaults["momentum"] == 0.9


def test_distribution_validate_args_is_composed_and_fingerprinted():
    jcfg, tcfg = configs("dreamer_v3")
    assert tcfg.distribution.validate_args is False
    assert tcfg.distribution.to_dict() == jcfg.distribution.to_dict()
    _, flipped = configs("dreamer_v3", ["distribution.validate_args=True"])
    assert config_fingerprint(flipped) != config_fingerprint(tcfg)
