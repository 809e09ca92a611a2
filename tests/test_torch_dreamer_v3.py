"""DreamerV3 training in the PyTorch port against the JAX package: one
train burst on TINY_DV3 (conv_impl=xla, the native-convolution form the port
implements) from the same converted parameters and optimizer states, the
same batch and the JAX package's own gumbel draws. Also one player step and
a CPU dry run of the CLI.

Tolerances: the ten metrics agree to rel 1e-4 (f32 sums in another order;
measured: 3e-7) and the updated parameters to atol 5e-6 (measured: 5e-7) —
a first Adam step moves a parameter by at most lr (1e-4 / 8e-5 here), and
where a gradient is as small as Adam's eps the step amplifies the last-bit
differences of that gradient."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import json
import os
import subprocess
import sys

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer_tiny import N_ACT, TINY_DV3, make_trainer
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent as torch_build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
from sheeprl_tpu_torch.config import compose as torch_compose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLA = ["algo.world_model.conv_impl=xla"]
T, B = 4, 2
OBS_SPACE = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)})
PARAM_ATOL = 5e-6


def tiny_batch():
    """The synthetic [1, T, B, ...] batch of dreamer_tiny.train_burst."""
    rng = np.random.default_rng(0)
    return {
        "rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3), np.uint8),
        "actions": np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))],
        "rewards": rng.standard_normal((1, T, B, 1)).astype(np.float32),
        "terminated": np.zeros((1, T, B, 1), np.float32),
        "truncated": np.zeros((1, T, B, 1), np.float32),
        "is_first": np.zeros((1, T, B, 1), np.float32),
    }


def torch_cfg(overrides=()):
    return torch_compose("config", TINY_DV3 + XLA + ["fabric.accelerator=cpu"] + list(overrides))


def torch_trainer(overrides=(), seed=0):
    cfg = torch_cfg(overrides)
    torch.manual_seed(seed)
    wm, actor, critic, target = torch_build_agent(cfg, OBS_SPACE, [N_ACT], False, torch.device("cpu"))
    opts = tdv3.build_optimizers(cfg, wm, actor, critic)
    train = tdv3.make_train_fn(wm, actor, critic, target, opts, cfg, False, [N_ACT])
    return cfg, (wm, actor, critic, target), opts, train


def torch_burst(overrides=(), noise=None, seed=0):
    """One burst of the port from a seeded init and seeded noise; returns
    (metrics as floats, modules)."""
    cfg, modules, _, train = torch_trainer(overrides, seed)
    batch = {k: torch.from_numpy(v) for k, v in tiny_batch().items()}
    gen = torch.Generator().manual_seed(seed)
    _, metrics = train(init_moments(), batch, noise=noise, generator=gen)
    return {k: float(v.mean()) for k, v in metrics.items()}, modules


def jax_train_noise(key, cfg, coupled: bool):
    """The gumbel draws the JAX one_step makes from ``key``, in the layout of
    the port's ``draw_train_noise``: jax.random.categorical(k, l) is
    argmax(l + jax.random.gumbel(k, l.shape))."""
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    horizon, TB = int(cfg.algo.horizon), T * B
    k_dyn, k_img, _ = jax.random.split(key, 3)
    if coupled:
        post = jnp.stack([jax.random.gumbel(k, (B, S, D)) for k in jax.random.split(k_dyn, T)])
    else:
        post = jax.random.gumbel(k_dyn, (T, B, S, D))
    k0, k = jax.random.split(k_img)
    act0 = [jax.random.gumbel(jax.random.split(k0, 1)[0], (TB, N_ACT))]
    img_z, img_a = [], []
    for ks in jax.random.split(k, horizon):
        k_img_s, k_a = jax.random.split(ks)
        img_z.append(jax.random.gumbel(k_img_s, (TB, S, D)))
        img_a.append(jax.random.gumbel(jax.random.split(k_a, 1)[0], (TB, N_ACT)))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return {"post": t(post), "act0": [t(a) for a in act0], "img_z": t(jnp.stack(img_z)), "img_a": [t(jnp.stack(img_a))]}


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def condition_two_hot_heads(params, seed=5):
    """Give the reward, critic and target-critic heads a bump of logits around
    the middle bin (plus small random weights). From their zero init the
    two-hot mean sums ±4.9e8-sized bins that cancel to ~0, so its f32 value is
    rounding noise of order 1 whose digits depend on the summation order:
    no two implementations agree on it. Concentrated heads keep the sums
    well conditioned, like trained ones."""
    rng = np.random.default_rng(seed)
    # rewards around symexp(2.05) ≈ 6.8, values around 0: advantages of
    # order one, so no metric is a difference of near-equal numbers
    for tree, centre in ((params["wm"]["reward"], 140), (params["critic"], 127)):
        n_in, bins = tree["out"]["kernel"].shape
        tree["out"]["kernel"] = (0.1 * rng.standard_normal((n_in, bins))).astype(np.float32)
        tree["out"]["bias"] = (-(((np.arange(bins) - centre) / 20.0) ** 2)).astype(np.float32)
    params["target_critic"] = jax.tree.map(np.copy, params["critic"])
    return params


def burst_parity(jax_overrides, torch_overrides, check_params=True):
    """Run one burst in both packages from the same state; assert metrics
    and (with ``check_params``) updated parameters agree."""
    train, params, opt_states, moments = make_trainer(XLA + list(jax_overrides))
    params0, opt0 = condition_two_hot_heads(_numpy_tree(params)), _numpy_tree(opt_states)
    params = jax.tree.map(jnp.asarray, params0)
    batch_np = tiny_batch()
    keys = jax.random.split(jax.random.key(7), 1)
    cfg, (wm, actor, critic, target), opts, ttrain = torch_trainer(torch_overrides)
    noise = jax_train_noise(keys[0], cfg, coupled=not cfg.algo.world_model.decoupled_rssm)
    new_params, _, _, jmetrics = train(
        params, opt_states, moments, jax.tree.map(jnp.asarray, batch_np), keys
    )
    convert.load_dreamer_v3(params0, wm, actor, critic, target, opt0, opts)
    _, tmetrics = ttrain(init_moments(), {k: torch.from_numpy(v) for k, v in batch_np.items()}, noise=[noise])
    for k in tdv3.METRIC_KEYS:
        assert float(tmetrics[k][0]) == pytest.approx(float(np.asarray(jmetrics[k])[0]), rel=1e-4), k
    if not check_params:
        return
    new_params = _numpy_tree(new_params)
    for key, module in (("wm", wm), ("actor", actor), ("critic", critic), ("target_critic", target)):
        expect = convert.params_to_state_dict(new_params[key], module)
        got = module.state_dict()
        assert expect.keys() == got.keys()
        for name, value in expect.items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=f"{key}.{name}")


def test_coupled_burst_matches_jax():
    burst_parity([], [])


def test_player_step_matches_jax():
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_player
    from sheeprl_tpu.config import compose
    from sheeprl_tpu.parallel import Distributed

    N = 2
    jcfg = compose("config", TINY_DV3 + XLA)
    jwm, jactor, _, params = build_agent(Distributed(devices=1), jcfg, OBS_SPACE, [N_ACT], False, jax.random.key(0))
    j_init, j_step = make_player(jwm, jactor, jcfg, [N_ACT], False, N)
    pparams = {"wm": params["wm"], "actor": params["actor"]}
    rng = np.random.default_rng(3)
    obs = {"rgb": rng.integers(0, 255, (N, 64, 64, 3), np.uint8)}
    key = jax.random.key(11)
    j_env, j_a, (j_h, j_z, _), _ = j_step(pparams, obs, j_init(pparams), key)
    _, k1, k2 = jax.random.split(key, 3)
    S, D = int(jcfg.algo.world_model.stochastic_size), int(jcfg.algo.world_model.discrete_size)
    noise = {
        "repr": torch.from_numpy(np.array(jax.random.gumbel(k1, (N, S, D)))),
        "act": [torch.from_numpy(np.array(jax.random.gumbel(jax.random.split(k2, 1)[0], (N, N_ACT))))],
    }

    cfg, (wm, actor, critic, target), _, _ = torch_trainer()
    convert.load_dreamer_v3(_numpy_tree(params), wm, actor, critic, target)
    t_init, t_step = tdv3.make_player(wm, actor, cfg, [N_ACT], False, N)
    t_env, t_a, (t_h, t_z, _) = t_step(obs, t_init(), noise=noise)
    np.testing.assert_array_equal(t_env.numpy(), np.asarray(j_env))
    np.testing.assert_allclose(t_a.numpy(), np.asarray(j_a), atol=1e-6)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_z.numpy(), np.asarray(j_z), atol=1e-6)


def test_cli_dry_run_on_cpu(tmp_path):
    """``python -m sheeprl_tpu_torch run`` trains on the dummy env on the CPU
    (the default overlapped loop) and logs its metrics to its telemetry
    stream, whose startup record says it ran on the CPU."""
    args = [
        sys.executable, "-m", "sheeprl_tpu_torch", "run", *TINY_DV3,
        "fabric.accelerator=cpu", "env.num_envs=2",
        "algo.total_steps=16", "algo.learning_starts=8", "metric.log_every=8",
        "algo.world_model.decoupled_rssm=True", "algo.world_model.pallas_gru=True",
    ]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    stream = next((tmp_path / "logs" / "runs").rglob("telemetry.jsonl"))
    events = [json.loads(l) for l in stream.read_text().splitlines()]
    assert events[0]["event"] == "startup" and events[0]["platform"] == "cpu"
    logs = [e for e in events if e["event"] == "log" and e["step"] == 16]
    assert logs and "Loss/world_model_loss" in logs[0]["metrics"], events[-3:]
    assert "[telemetry rank=0] platform=cpu" in proc.stderr


def test_cli_refuses_overlap_and_mixed_precision(tmp_path, monkeypatch):
    """The CLI refuses what the port does not run, before it writes
    anything: an unknown fleet act mode and a precision the policy table
    does not hold. (The overlap engine, memmap buffers, bf16-mixed, the
    fleet's worker mode and its batched act service, refused here before
    they were ported, run now: the act service's runs are in
    tests/test_torch_act_service.py. Video capture runs too: where no video
    writer imports it warns, as the JAX package does, and the run goes on.)"""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.fleet.engine import FleetEngine

    monkeypatch.chdir(tmp_path)
    assert FleetEngine.configured(compose("config", TINY_DV3 + ["fabric.accelerator=cpu", "algo.fleet.workers=2",
                                                                "fleet.act_mode=inference"]))
    with pytest.raises(ValueError, match=r"fleet.act_mode must be worker \| inference"):
        cli.run(TINY_DV3 + ["fabric.accelerator=cpu", "algo.fleet.workers=2", "fleet.act_mode=learner"])
    with pytest.raises(ValueError, match="Unknown precision '16-mixed'"):
        cli.run(TINY_DV3 + ["fabric.accelerator=cpu", "fabric.precision=16-mixed"])
    assert not (tmp_path / "logs").exists()
    with pytest.warns(UserWarning, match="Video capture unavailable; continuing without RecordVideo"):
        cli.run(TINY_DV3 + ["fabric.accelerator=cpu", "env.capture_video=True", "dry_run=True", "env.num_envs=1",
                            "algo.per_rank_sequence_length=2",
                            "buffer.memmap=False", "metric.log_level=0", "algo.run_test=False"])
    assert list((tmp_path / "logs").rglob("*.ckpt")), "the run went on past the warning"


def test_config_refuses_what_the_port_does_not_run():
    """A key the port's configs do not hold fails at composition (it would
    be silently ignored otherwise); conv_impl=einsum raises at build; 32-true
    turns TF32 off for cuBLAS and cuDNN."""
    for key in ("metric.telemetry.transfer_counter=False", "gateway.replicas=2", "num_threads=4",
                "diag.mem.census_every=0", "diag.bench.threshold=0.1"):
        with pytest.raises(KeyError, match="does not exist"):
            torch_cfg([key])
    with pytest.raises(NotImplementedError, match="conv_impl=einsum"):
        torch_build_agent(torch_cfg(["algo.world_model.conv_impl=einsum"]), OBS_SPACE, [N_ACT], False,
                          torch.device("cpu"))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        tdv3.check_precision(torch_cfg())
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
