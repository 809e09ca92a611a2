"""bf16 in the PyTorch port against the JAX package: the precision table, the
cast boundary of the train step, and one TINY_DV3 burst under bf16-mixed and
bf16-true in both packages from the same converted parameters, batch and
gumbel draws.

Tolerance: the ten metrics agree to rel 3e-2. A bf16 rounding moves a value
by up to 2^-8 (0.4%), and the packages round in different places: XLA fuses
chains of elementwise ops and rounds their result once, PyTorch rounds every
op's output, and the two accumulate a product's terms in different orders.
Measured on this burst: at most 0.97% (the coupled policy loss; the world
model's losses within 0.3%), against 3e-7 under 32-true. bf16-mixed itself
moves the losses by up to 0.9% from 32-true on this burst."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import numpy as np
import pytest
import torch

import test_torch_dreamer_v3 as tdv3_test
from dreamer_tiny import N_ACT, make_trainer
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.dreamer_v3.utils import PrecisionApplies, init_moments, make_precision_applies
from sheeprl_tpu_torch.parallel.precision import _PRECISION_POLICIES, cast_floating, get_precision

BF16_REL = 3e-2
DECOUPLED = ["algo.world_model.decoupled_rssm=True"]


def _bursts(overrides):
    """Metrics of one burst in each package (JAX, port) and the port's
    modules after it."""
    train, params, opt_states, moments = make_trainer(tdv3_test.XLA + list(overrides))
    params0 = tdv3_test.condition_two_hot_heads(tdv3_test._numpy_tree(params))
    opt0 = tdv3_test._numpy_tree(opt_states)
    batch_np = tdv3_test.tiny_batch()
    keys = jax.random.split(jax.random.key(7), 1)
    cfg, (wm, actor, critic, target), opts, ttrain = tdv3_test.torch_trainer(overrides)
    noise = tdv3_test.jax_train_noise(keys[0], cfg, coupled=not cfg.algo.world_model.decoupled_rssm)
    _, _, _, jm = train(jax.tree.map(jax.numpy.asarray, params0), opt_states, moments,
                        jax.tree.map(jax.numpy.asarray, batch_np), keys)
    if cfg.fabric.precision == "bf16-true":  # as the training loop does, before any state is loaded
        for m in (wm, actor, critic, target):
            m.to(torch.bfloat16)
    convert.load_dreamer_v3(params0, wm, actor, critic, target, opt0, opts)
    for opt in (opts.wm, opts.actor, opts.critic):  # the Adam moments in the parameters' dtype
        for st in opt.optimizer.state.values():
            for k, v in st.items():
                if k != "step" and v.is_floating_point():
                    st[k] = v.to(next(wm.parameters()).dtype)
    _, tm = ttrain(init_moments(), {k: torch.from_numpy(v) for k, v in batch_np.items()}, noise=[noise])
    jax_m = {k: float(np.asarray(jm[k])[0]) for k in tdv3.METRIC_KEYS}
    torch_m = {k: float(tm[k][0]) for k in tdv3.METRIC_KEYS}
    return jax_m, torch_m, (wm, actor, critic, target), opts


@pytest.mark.parametrize("world_model", ["coupled", "decoupled"])
def test_bf16_mixed_burst_matches_jax(world_model):
    jax_m, torch_m, modules, opts = _bursts(["fabric.precision=bf16-mixed"] + (DECOUPLED if world_model == "decoupled" else []))
    for k in tdv3.METRIC_KEYS:
        assert np.isfinite(torch_m[k]), k
        assert torch_m[k] == pytest.approx(jax_m[k], rel=BF16_REL), k
    # the masters, the optimizer moments and the metrics stay f32
    for m in modules:
        assert all(p.dtype == torch.float32 for p in m.parameters())
    for opt in (opts.wm, opts.actor, opts.critic):
        for st in opt.optimizer.state.values():
            assert all(v.dtype == torch.float32 for v in st.values() if v.is_floating_point())


def test_bf16_true_burst_matches_jax_with_bf16_parameters():
    """bf16-true computes as bf16-mixed does on the first burst; the port's
    parameters (and so its Adam moments) are bf16 themselves."""
    jax_m, torch_m, modules, opts = _bursts(["fabric.precision=bf16-true"])
    for k in tdv3.METRIC_KEYS:
        assert torch_m[k] == pytest.approx(jax_m[k], rel=BF16_REL), k
    for m in modules:
        assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    st = next(iter(opts.wm.optimizer.state.values()))
    assert st["exp_avg"].dtype == torch.bfloat16


def test_bf16_mixed_stays_close_to_f32():
    """The port alone: the same burst under 32-true and bf16-mixed."""
    m32, _ = tdv3_test.torch_burst()
    m16, _ = tdv3_test.torch_burst(["fabric.precision=bf16-mixed"])
    for k in tdv3.METRIC_KEYS:
        assert m16[k] == pytest.approx(m32[k], rel=BF16_REL, abs=1e-3), k


@pytest.mark.parametrize("name", sorted(_PRECISION_POLICIES))
def test_precision_table_matches_jax(name):
    from sheeprl_tpu.parallel.mesh import get_precision as jax_get_precision

    mine, ref = get_precision(name), jax_get_precision(name)
    assert mine.name == ref.name
    assert str(mine.param_dtype).split(".")[-1] == np.dtype(ref.param_dtype).name
    assert str(mine.compute_dtype).split(".")[-1] == np.dtype(ref.compute_dtype).name


def test_unknown_precision_gives_the_jax_packages_error():
    from sheeprl_tpu.parallel.mesh import get_precision as jax_get_precision

    with pytest.raises(ValueError) as ref:
        jax_get_precision("16-mixed")
    with pytest.raises(ValueError) as mine:
        get_precision("16-mixed")
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="Unknown precision"):
        tdv3_test.torch_trainer(["fabric.precision=16-mixed"])


def test_mixed_precision_does_not_select_the_kernel(capsys, monkeypatch):
    """decoupled_rssm with pallas_gru=True under bf16-mixed: both packages
    print the UNUSED line and run the step-by-step GRU."""
    overrides = DECOUPLED + ["algo.world_model.pallas_gru=True", "fabric.precision=bf16-mixed"]
    make_trainer(tdv3_test.XLA + overrides)
    jax_err = capsys.readouterr().err
    assert "UNUSED: mixed precision (the kernel computes in f32)" in jax_err

    def no_kernel(*a, **k):
        raise AssertionError("the LN-GRU sequence ran under bf16-mixed")

    monkeypatch.setattr(tdv3.ln_gru, "gru_sequence", no_kernel)
    cfg, _, _, train = tdv3_test.torch_trainer(overrides)
    assert "UNUSED: mixed precision (the kernel computes in f32)" in capsys.readouterr().err
    batch = {k: torch.from_numpy(v) for k, v in tdv3_test.tiny_batch().items()}
    _, metrics = train(init_moments(), batch, generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v[0])) for v in metrics.values())


def test_cast_boundary_casts_once_and_reaches_the_masters():
    cfg = tdv3_test.torch_cfg(["fabric.precision=bf16-mixed"])
    applies = make_precision_applies(cfg)
    assert isinstance(applies, PrecisionApplies) and applies.mixed
    lin = torch.nn.Linear(4, 3)
    master = lin.weight
    with applies.params(lin):
        assert lin.weight.dtype == torch.bfloat16 and lin.weight is not master
        copy = lin.weight
        out = applies(lin, torch.ones(2, 4))
        assert lin.weight is copy  # one cast for the whole block
    assert out.dtype == torch.float32 and lin.weight is master
    out.sum().backward()
    assert master.grad is not None and master.grad.dtype == torch.float32
    # noise stays f32 inside the boundary; other floating inputs go in as bf16
    seen = {}
    applies(lambda x, noise=None: seen.update(x=x.dtype, noise=noise.dtype), torch.ones(1), noise=torch.ones(1))
    assert seen == {"x": torch.bfloat16, "noise": torch.float32}
    f32 = make_precision_applies(tdv3_test.torch_cfg())
    with f32.params(lin):
        assert lin.weight is master
    assert cast_floating({"a": [torch.ones(1, dtype=torch.int64)]}, torch.bfloat16)["a"][0].dtype == torch.int64


@pytest.mark.parametrize("size", ["M", "L", "XL"])
def test_presets_compose_to_the_jax_packages_algo(size):
    """algo=dreamer_v3_{M,L,XL}: the port's algo section is the JAX package's,
    restricted to the keys the port reads."""
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.config import compose as torch_compose

    mine = torch_compose("config", ["exp=dreamer_v3", f"algo=dreamer_v3_{size}"]).algo.to_dict()
    ref = jax_compose("config", ["exp=dreamer_v3", f"algo=dreamer_v3_{size}"]).algo.to_dict()

    def within(a, b, path="algo"):
        for k, v in a.items():
            assert k in b, f"{path}.{k}"
            if isinstance(v, dict):
                within(v, b[k], f"{path}.{k}")
            elif isinstance(v, str) and v.startswith("sheeprl_tpu_torch."):  # the same callable in each package
                assert v.replace("sheeprl_tpu_torch.", "sheeprl_tpu.", 1) == b[k], (f"{path}.{k}", v, b[k])
            else:
                assert v == b[k], (f"{path}.{k}", v, b[k])

    within(mine, ref)
    assert mine["world_model"]["recurrent_model"]["recurrent_state_size"] == {"M": 1024, "L": 2048, "XL": 4096}[size]


def test_preset_M_coupled_train_step_on_cpu():
    """DreamerV3-M, coupled (its default), one gradient step at a cut batch
    and sequence length on the CPU."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose as torch_compose

    cfg = torch_compose("config", ["exp=dreamer_v3", "algo=dreamer_v3_M", "env=dummy", "fabric.accelerator=cpu",
                                   "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=2", "algo.horizon=2",
                                   "algo.cnn_keys.encoder=[rgb]"])
    assert not cfg.algo.world_model.decoupled_rssm
    torch.manual_seed(0)
    wm, actor, critic, target = build_agent(cfg, tdv3_test.OBS_SPACE, [N_ACT], False, torch.device("cpu"))
    opts = tdv3.build_optimizers(cfg, wm, actor, critic)
    train = tdv3.make_train_fn(wm, actor, critic, target, opts, cfg, False, [N_ACT])
    rng = np.random.default_rng(0)
    batch = {
        "rgb": torch.from_numpy(rng.integers(0, 255, (1, 2, 2, 64, 64, 3), np.uint8)),
        "actions": torch.from_numpy(np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, 2, 2))]),
        "rewards": torch.zeros(1, 2, 2, 1), "terminated": torch.zeros(1, 2, 2, 1),
        "truncated": torch.zeros(1, 2, 2, 1), "is_first": torch.zeros(1, 2, 2, 1),
    }
    _, metrics = train(init_moments(), batch, generator=torch.Generator().manual_seed(0))
    assert opts.step == 1
    assert all(np.isfinite(float(v[0])) for v in metrics.values())
