"""The actor fleet's worker-mode acting in the PyTorch port against the JAX
package on the CPU: the SAC and DreamerV3 act cores, and one ``step()`` of
the SAC, DreamerV3 and PPO worker programs, from the same parameters
(converted), the same env seeds and the noise the JAX package's per-row keys
draw (threefry and Philox never agree, so the port's cores take pre-drawn
noise: one row per env slot).

Tolerances: the actions and the recurrent state agree to atol 1e-5 (f32
sums in another order; measured below 1e-6), discrete actions exactly, and
every other array of a program's packet (observations, rewards, flags)
exactly. A row's action is unchanged when the batch is padded with other
rows (atol 1e-6), and the port's slot generators give each slot its own
draws whatever the batch width.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamer_tiny import N_ACT, TINY_DV3
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.config import compose as torch_compose
from sheeprl_tpu_torch.engine import RecordingSink
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.fleet.act_core import build_act_core, slot_generators

ATOL = 1e-5
SAC_ARGS = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "algo.hidden_size=8", "env.num_envs=4",
            "algo.learning_starts=0"]
# the vector observation alone: the same recurrence and heads as the pixel
# path (tests/test_torch_dreamer_v3.py holds the convolutions), a fraction
# of the JAX package's compile time
DV3_ARGS = TINY_DV3 + ["algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", "env.num_envs=4",
                       "algo.learning_starts=0"]
PPO_ARGS = ["exp=ppo", "env=dummy", "env.num_envs=4", "algo.rollout_steps=3", "algo.dense_units=8",
            "algo.mlp_layers=1"]


def _cfgs(args):
    from sheeprl_tpu.config import compose

    return compose("config", args), torch_compose("config", args + ["fabric.accelerator=cpu"])


def _sac_params(jcfg):
    from sheeprl_tpu.algos.sac.agent import SACActor

    space = gym.spaces.Box(-1.0, 1.0, (2,), np.float32)
    actor = SACActor(action_dim=2, hidden_size=8, action_low=space.low.tolist(), action_high=space.high.tolist())
    return actor.init(jax.random.PRNGKey(1), jnp.zeros((1, 10)))["params"], space


def _sac_noise(key, n, act_dim=2):
    from sheeprl_tpu.fleet.act_core import row_keys

    return np.stack([np.asarray(jax.random.normal(k, (1, act_dim)))[0] for k in row_keys(key, n)])


def test_sac_act_core_matches_jax_and_is_pad_invariant():
    from sheeprl_tpu.fleet.act_core import build_act_core as jax_build
    from sheeprl_tpu.fleet.act_core import row_keys

    jcfg, tcfg = _cfgs(SAC_ARGS)
    jparams, space = _sac_params(jcfg)
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    jcore = jax_build("sac", jcfg, obs_space, space)
    tcore = build_act_core("sac", tcfg, spaces.Dict({"state": spaces.Box(-20, 20, (10,), np.float32)}),
                           spaces.Box(-1.0, 1.0, (2,), np.float32))
    actor = tcore.extract_params({"actor": {k: v.numpy() for k, v in
                                            convert.params_to_state_dict(jparams, tcore.actor).items()}})
    obs = np.random.default_rng(0).standard_normal((4, 10)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jcore.act(jparams, obs, row_keys(key, 4))[0])
    noise = torch.from_numpy(_sac_noise(key, 4))
    got, _, _ = tcore.act(actor, obs, noise)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # row i depends on obs[i] and its own noise alone
    part, _, _ = tcore.act(actor, obs[:2], noise[:2])
    np.testing.assert_allclose(part.numpy(), got.numpy()[:2], atol=1e-6, rtol=0)
    # each slot's generator draws the same rows whatever the batch width
    a, b = tcore.draw_noise(slot_generators(7, 4)), tcore.draw_noise(slot_generators(7, 2))
    assert torch.equal(a[:2], b) and not torch.equal(a[0], a[1])


def _dv3_setup():
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu.fleet.act_core import build_act_core as jax_build
    from sheeprl_tpu.parallel import Distributed

    jcfg, tcfg = _cfgs(DV3_ARGS)
    obs_space = gym.spaces.Dict({"state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    _, _, _, params = build_agent(Distributed(devices=1), jcfg, obs_space, [N_ACT], False, jax.random.key(0))
    jparams = {"wm": params["wm"], "actor": params["actor"]}
    jcore = jax_build("dreamer_v3", jcfg, obs_space, gym.spaces.Discrete(N_ACT))
    tcore = build_act_core("dreamer_v3", tcfg, spaces.Dict({"state": spaces.Box(-20, 20, (10,), np.float32)}),
                           spaces.Discrete(N_ACT))
    sds = {k: {n: v.numpy() for n, v in convert.params_to_state_dict(jparams[k], tcore.modules[k]).items()}
           for k in ("wm", "actor")}
    return jcfg, jcore, jparams, tcore, tcore.extract_params(sds)


def _dv3_noise(jcfg, key, n, n_act=N_ACT):
    """The per-row draws of the JAX core's row step: split(row key) into the
    representation's gumbel and the actor's (one split per head)."""
    from sheeprl_tpu.fleet.act_core import row_keys

    S, D = int(jcfg.algo.world_model.stochastic_size), int(jcfg.algo.world_model.discrete_size)
    rep, act = [], []
    for k in row_keys(key, n):
        k1, k2 = jax.random.split(k)
        rep.append(np.asarray(jax.random.gumbel(k1, (1, S, D)))[0])
        act.append(np.asarray(jax.random.gumbel(jax.random.split(k2, 1)[0], (1, n_act)))[0])
    return {"repr": torch.from_numpy(np.stack(rep)), "act": [torch.from_numpy(np.stack(act))]}


def test_dreamer_v3_act_core_matches_jax_and_is_pad_invariant():
    from sheeprl_tpu.fleet.act_core import row_keys

    jcfg, jcore, jparams, tcore, mods = _dv3_setup()
    n = 4
    obs = {"state": np.random.default_rng(3).standard_normal((n, 10)).astype(np.float32)}
    jstate, tstate = jcore.init_state(jparams, n), tcore.init_state(mods, n)
    for step in range(2):  # a second step from the first's (h, z, a)
        key = jax.random.PRNGKey(11 + step)
        j_env, j_a, jstate = jcore.act(jparams, obs, row_keys(key, n), state=jstate)
        t_env, t_a, tstate = tcore.act(mods, obs, _dv3_noise(jcfg, key, n), state=tstate)
        np.testing.assert_array_equal(t_env.numpy(), np.asarray(j_env))
        np.testing.assert_allclose(t_a.numpy(), np.asarray(j_a), atol=ATOL, rtol=0)
        for t, j in zip(tstate, jstate):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=1e-5)
    # a reset of rows 1 and 3 gives them the initial state again, as the JAX core
    mask = np.array([False, True, False, True])
    for t, j in zip(tcore.reset_state(mods, mask, tstate), jcore.reset_state(jparams, mask, jstate)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=1e-5)
    # rows 0-1 alone from the same state and noise: the same actions and state
    noise = _dv3_noise(jcfg, jax.random.PRNGKey(20), n)
    full = tcore.act(mods, obs, noise, state=tstate)
    part = tcore.act(mods, {"state": obs["state"][:2]}, {"repr": noise["repr"][:2], "act": [noise["act"][0][:2]]},
                     state=tuple(s[:2] for s in tstate))
    np.testing.assert_array_equal(part[0].numpy(), full[0].numpy()[:2])
    for a, b in zip(part[2], full[2]):
        np.testing.assert_allclose(a.numpy(), b.numpy()[:2], atol=1e-6, rtol=0)


def _same_sinks(tsink, jsink):
    assert [o[0] for o in tsink.ops] == [o[0] for o in jsink.ops] and [o[2] for o in tsink.ops] == [
        o[2] for o in jsink.ops]
    for (_, td, _, _), (_, jd, _, _) in zip(tsink.ops, jsink.ops):
        assert sorted(td) == sorted(jd)
        for k in td:
            if k == "actions":
                np.testing.assert_allclose(td[k], np.asarray(jd[k]), atol=ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(td[k], np.asarray(jd[k]), err_msg=k)


def _jax_worker_key(cfg, worker_id):
    return jax.random.PRNGKey(int(cfg.seed) + 977 * (worker_id + 1))


def test_sac_program_step_matches_jax():
    from sheeprl_tpu.engine import RecordingSink as JaxSink
    from sheeprl_tpu.fleet.programs import sac_program as jax_program
    from sheeprl_tpu_torch.fleet.programs import sac_program

    jcfg, tcfg = _cfgs(SAC_ARGS)
    jparams, _ = _sac_params(jcfg)
    jprog, tprog = jax_program(jcfg, 1, 2), sac_program(tcfg, 1, 2)
    jprog.set_params({"actor": jparams}, 1)
    tprog.set_params({"actor": {k: v.numpy() for k, v in
                                convert.params_to_state_dict(jparams, tprog.core.actor).items()}}, 1)
    jkey = _jax_worker_key(jcfg, 1)
    for prog in (jprog, tprog):
        prog.lifetime = 8
    for _ in range(2):
        jkey, k = jax.random.split(jkey)
        tprog.core.draw_noise = lambda gens, k=k: torch.from_numpy(_sac_noise(k, len(gens)))
        jsink, tsink = JaxSink(), RecordingSink()
        assert jprog.step(jsink)[0] == tprog.step(tsink)[0] == 2
        _same_sinks(tsink, jsink)


def test_dreamer_v3_program_step_matches_jax():
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu.engine import RecordingSink as JaxSink
    from sheeprl_tpu.fleet.programs import dreamer_v3_program as jax_program
    from sheeprl_tpu.parallel import Distributed
    from sheeprl_tpu_torch.fleet.programs import dreamer_v3_program

    jcfg, tcfg = _cfgs(DV3_ARGS)
    jprog, tprog = jax_program(jcfg, 1, 2), dreamer_v3_program(tcfg, 1, 2)
    _, _, _, params = build_agent(Distributed(devices=1), jcfg, jprog.envs.single_observation_space,
                                  jprog.actions_dim, False, jax.random.key(0))
    jparams = {"wm": params["wm"], "actor": params["actor"]}
    jprog.set_params(jparams, 1)
    tprog.set_params({k: {n: v.numpy() for n, v in convert.params_to_state_dict(
        jparams[k], tprog.core.modules[k]).items()} for k in ("wm", "actor")}, 1)
    jkey = _jax_worker_key(jcfg, 1)
    for prog in (jprog, tprog):
        prog.lifetime = 8
    n_act = jprog.actions_dim[0]
    for _ in range(3):
        jkey, k = jax.random.split(jkey)
        tprog.core.draw_noise = lambda gens, k=k: _dv3_noise(jcfg, k, len(gens), n_act)
        jsink, tsink = JaxSink(), RecordingSink()
        assert jprog.step(jsink)[0] == tprog.step(tsink)[0] == 2
        _same_sinks(tsink, jsink)


def test_ppo_program_step_matches_jax():
    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build
    from sheeprl_tpu.fleet.programs import ppo_program as jax_program
    from sheeprl_tpu.parallel import Distributed
    from sheeprl_tpu_torch.fleet.programs import ppo_program

    jcfg, tcfg = _cfgs(PPO_ARGS)
    jprog, tprog = jax_program(jcfg, 0, 2), ppo_program(tcfg, 0, 2)
    _, jparams = jax_build(Distributed(devices=1, accelerator="cpu"), jcfg, jprog.obs_space, jprog.action_space,
                           jax.random.PRNGKey(3))
    jprog.set_params(jparams, 1)
    tprog.set_params({"agent": {k: v.numpy() for k, v in
                                convert.params_to_state_dict(jparams, tprog.agent).items()}}, 1)
    keys = [_jax_worker_key(jcfg, 0)]
    act = tprog._act

    def act_with_jax_draws(agent, obs, generator=None):
        # the JAX program splits its key once per env step; categorical
        # sampling is argmax(logits + gumbel), one split key per head
        keys[0], ak = jax.random.split(keys[0])
        logits = agent(obs)[0][0]
        head = jax.random.split(ak, 1)[0]
        return act(agent, obs, noise=[torch.from_numpy(np.array(jax.random.gumbel(head, tuple(logits.shape))))])

    tprog._act = act_with_jax_draws
    j_steps, (j_local, j_next, j_stats) = jprog.step(None)
    t_steps, (t_local, t_next, t_stats) = tprog.step(None)
    assert j_steps == t_steps == 6 and t_stats == j_stats
    assert sorted(t_local) == sorted(j_local)
    for k in t_local:
        if k in ("logprobs", "values"):
            np.testing.assert_allclose(t_local[k], np.asarray(j_local[k]), atol=ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(t_local[k], np.asarray(j_local[k]), err_msg=k)
    np.testing.assert_allclose(t_next, np.asarray(j_next), atol=ATOL, rtol=0)
