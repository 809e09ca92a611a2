"""The small library pieces of the PyTorch port held to the JAX package on
the CPU:

* the aggregator kinds ``mean``, ``sum``, ``max``, ``min`` and ``last``
  (``utils/metric.py``) against ``RunningMetric`` on the same updates
  (scalars, arrays, empty arrays, a NaN), exactly (float64 on the host),
  and the telemetry facade builds each kind from the config;
* ``MultiEncoder`` and ``MultiDecoder`` (``models/models.py``) against the
  flax modules from the same parameters (``convert.load_multi``: NHWC
  flattening, dense kernels ``[in,out]`` → ``[out,in]``), atol 1e-5 on
  features and reconstructions (f32 convolutions in another order);
* ``MinedojoActor`` against the JAX package's with the same parameters and
  the gumbel draws of the JAX keys: masked (each action-type row gating its
  argument heads) and unmasked, the sampled indices exactly, the
  straight-through one-hot values and the masked heads' probabilities to
  atol 1e-6.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.utils.metric import KINDS, MetricAggregator, RunningMetric

UPDATES = [1.5, np.array([2.0, -3.0, 0.25]), np.zeros((0,)), np.array([[4.0], [0.5]]), -0.75]


@pytest.mark.parametrize("kind", KINDS)
def test_aggregator_kinds_match_running_metric(kind, monkeypatch):
    from sheeprl_tpu.utils.metric import MetricAggregator as JaxAggregator
    from sheeprl_tpu.utils.metric import RunningMetric as JaxMetric

    # the JAX CLI sets this class-wide switch from a run's metric.log_level,
    # and an earlier test in the same process may have left it on
    monkeypatch.setattr(JaxAggregator, "disabled", False)
    port, ref = RunningMetric(kind), JaxMetric(kind)
    assert port.compute() == ref.compute()  # nothing yet
    for value in UPDATES:
        port.update(value)
        ref.update(value)
        assert port.compute() == ref.compute(), (kind, value)
    port.reset()
    assert port.compute() is None
    # the aggregator leaves NaN out on compute, as the JAX package's
    agg, jagg = MetricAggregator({"a": kind, "b": kind}), JaxAggregator({"a": {"kind": kind}, "b": {"kind": kind}})
    for a in (agg, jagg):
        a.update("a", 2.0)
        a.update("b", float("nan"))
        a.update("c", 1.0)  # not built with it: ignored
    assert agg.compute() == jagg.compute() == {"a": 2.0}
    with pytest.raises(ValueError, match="kind"):
        RunningMetric("median")


def test_telemetry_builds_every_kind_from_the_config():
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.telemetry.facade import Telemetry

    cfg = compose("config", ["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "metric.telemetry.enabled=False"])
    cfg.metric.aggregator.metrics["Rewards/rew_avg"]["kind"] = "max"
    cfg.metric.aggregator.metrics["Game/ep_len_avg"]["kind"] = "sum"
    telem = Telemetry.setup(cfg, None, aggregator_keys={"Rewards/rew_avg", "Game/ep_len_avg"})
    for v in (1.0, 3.0, 2.0):
        telem.aggregator.update("Rewards/rew_avg", v)
        telem.aggregator.update("Game/ep_len_avg", v)
    assert telem.aggregator.compute() == {"Rewards/rew_avg": 3.0, "Game/ep_len_avg": 6.0}
    telem.close(0)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_multi_encoder_and_decoder_match_flax():
    from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
    from sheeprl_tpu.models.models import MultiDecoder as JaxDecoder
    from sheeprl_tpu.models.models import MultiEncoder as JaxEncoder
    from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent
    from sheeprl_tpu_torch.models import MultiDecoder, MultiEncoder

    rng = np.random.default_rng(0)
    obs = {"rgb": rng.integers(0, 255, (3, 64, 64, 3)).astype(np.float32) / 255.0 - 0.5,
           "state": rng.standard_normal((3, 5)).astype(np.float32)}
    cases = [("both", ("rgb",), ("state",)), ("mlp", (), ("state",))]
    for name, cnn, mlp in cases:
        jenc = JaxEncoder(jagent.DV3CNNEncoder(cnn, 2, conv_impl="xla") if cnn else None,
                          jagent.DV3MLPEncoder(mlp, 2, 8) if mlp else None)
        jparams = jenc.init(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in obs.items()})["params"]
        tenc = MultiEncoder(tagent.DV3CNNEncoder(cnn, 3, 2, 64) if cnn else None,
                            tagent.DV3MLPEncoder(mlp, 5, 2, 8) if mlp else None)
        convert.load_multi(_numpy(jparams), tenc)
        want = np.asarray(jenc.apply({"params": jparams}, {k: jnp.asarray(v) for k, v in obs.items()}))
        with torch.no_grad():
            got = tenc({k: torch.from_numpy(v) for k, v in obs.items()}).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)

        latent = rng.standard_normal((3, 24)).astype(np.float32)
        jdec = JaxDecoder(jagent.DV3CNNDecoder(cnn, [3], 2, conv_impl="xla") if cnn else None,
                          jagent.DV3MLPDecoder(mlp, [5], 2, 8) if mlp else None)
        jparams = jdec.init(jax.random.PRNGKey(2), jnp.asarray(latent))["params"]
        tdec = MultiDecoder(tagent.DV3CNNDecoder(cnn, [3], 2, 24) if cnn else None,
                            tagent.DV3MLPDecoder(mlp, [5], 24, 2, 8) if mlp else None)
        convert.load_multi(_numpy(jparams), tdec)
        want = jdec.apply({"params": jparams}, jnp.asarray(latent))
        with torch.no_grad():
            got = tdec(torch.from_numpy(latent))
        assert sorted(got) == sorted(want) == sorted(cnn + mlp), name
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=f"{name}/{k}")
    with pytest.raises(ValueError, match="MultiEncoder needs"):
        MultiEncoder(None, None)


DIMS = (19, 5, 6)  # MineDojo's heads: action type, craft/smelt argument, item argument


def _masks(n):
    m = {"mask_action_type": np.zeros((n, DIMS[0]), bool), "mask_craft_smelt": np.ones((n, DIMS[1]), bool),
         "mask_equip_place": np.ones((n, DIMS[2]), bool), "mask_destroy": np.ones((n, DIMS[2]), bool)}
    # row r may take only one action type, so the argument masks it gates
    # are the ones that apply: craft (15), equip (16), place (17), destroy (18)
    for r, t in enumerate((15, 16, 17, 18, 3)):
        m["mask_action_type"][r, t] = True
    m["mask_craft_smelt"][0, :3] = False
    m["mask_equip_place"][1:3, 1:] = False
    m["mask_destroy"][3, ::2] = False
    return m


def test_minedojo_actor_masked_and_unmasked_sampling_matches_jax():
    from sheeprl_tpu.algos.dreamer_v3 import agent as jagent
    from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tagent

    n, latent = 5, 12
    jactor = jagent.MinedojoActor(actions_dim=DIMS, is_continuous=False, mlp_layers=1, dense_units=8)
    state = np.random.default_rng(4).standard_normal((n, latent)).astype(np.float32)
    jparams = jactor.init(jax.random.PRNGKey(0), jnp.asarray(state))["params"]
    tactor = tagent.MinedojoActor(latent, DIMS, False, mlp_layers=1, dense_units=8)
    convert.load_params(_numpy(jparams), tactor)
    jpre = jactor.apply({"params": jparams}, jnp.asarray(state))
    with torch.no_grad():
        tpre = tactor(torch.from_numpy(state))
    for mask in (_masks(n), None):
        key = jax.random.PRNGKey(9)
        jacts, jdists = jagent.sample_actor_actions(jactor, jpre, key, mask=mask)
        keys = jax.random.split(key, len(DIMS))
        noise = [torch.from_numpy(np.array(jax.random.gumbel(k, (n, d)))) for k, d in zip(keys, DIMS)]
        tacts, tdists = tagent.sample_actor_actions(tactor, tpre, noise, mask=mask)
        for t, j in zip(tacts, jacts):  # straight-through samples: one-hot up to last-bit float noise
            np.testing.assert_array_equal(t.numpy().argmax(-1), np.asarray(j).argmax(-1))
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)
        for t, j in zip(tdists, jdists):
            np.testing.assert_allclose(t.probs.numpy(), np.asarray(j.probs), atol=1e-6, rtol=0)
        if mask is not None:  # the masks held: every sample is an allowed action
            a = [x.numpy().argmax(-1) for x in tacts]
            assert (a[0] == np.array([15, 16, 17, 18, 3])).all()
            assert a[1][0] >= 3 and a[2][1] == 0 and a[2][2] == 0 and a[2][3] % 2 == 1
    # greedy with masks: the mode of each masked head
    g, _ = tagent.sample_actor_actions(tactor, tpre, greedy=True, mask=_masks(n))
    jg, _ = jagent.sample_actor_actions(jactor, jpre, None, greedy=True, mask=_masks(n))
    for t, j in zip(g, jg):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_minedojo_actor_is_accepted_by_the_config():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MinedojoActor, build_actor_critic
    from sheeprl_tpu_torch.config import compose

    cfg = compose("config", ["exp=dreamer_v3", "env=dummy", "fabric.accelerator=cpu", "algo.dense_units=8",
                             "algo.mlp_layers=1",
                             "algo.actor.cls=sheeprl_tpu_torch.algos.dreamer_v3.agent.MinedojoActor"])
    actor, _ = build_actor_critic(cfg, 12, DIMS, False)
    assert type(actor) is MinedojoActor and actor.masked_heads
    cfg.algo.actor.cls = "sheeprl_tpu_torch.algos.dreamer_v2.agent.DV2Actor"
    with pytest.raises(NotImplementedError, match="MinedojoActor"):
        build_actor_critic(cfg, 12, DIMS, False)
