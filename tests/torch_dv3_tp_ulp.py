"""The JAX package's DreamerV3 step on the ``(1,2,2)`` mesh of
``tests/test_torch_mesh_sharded.py`` (the tiny model with ``dense_units``
128, decoupled on the interpret-mode Pallas GRU, ``min_shard_size`` 64, its
batch and keys; and again on the XLA GRU, ``pallas_gru=False``): with the
parameters and optimizer states replicated, laid
out by the JAX package's own rule engine (``shard_params``,
``shard_opt_state``), and replicated again with every parameter moved by
about one f32 ulp (times ``1 + 2**-23·u``, ``u`` uniform in [-1, 1], three
draws, on the Pallas GRU), and on the XLA GRU with one tree laid out at a
time. Prints every loss of each step (ROADMAP Queue 3 item 16: does the
sharded step leave the replicated one by more than the step's own
sensitivity to rounding?), then each world-model method alone, sharded
against replicated (``pieces``). The step does not run in f64
(``jax_enable_x64``): its lambda-return scan mixes f32 and f64 carries.

Usage: ``cd tests && PYTHONPATH=..:. python torch_dv3_tp_ulp.py`` (about
two minutes)."""
import os


def run() -> None:
    from sheeprl_tpu.utils.virtual_mesh import force_virtual_cpu_mesh

    force_virtual_cpu_mesh(8)
    for gru in ("interpret", "False"):
        step(f"algo.world_model.pallas_gru={gru}", ulp=gru == "interpret")
    pieces()


def step(gru: str, ulp: bool) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dreamer_tiny import N_ACT
    from test_torch_dreamer_v3 import XLA, _numpy_tree, condition_two_hot_heads
    from test_torch_mesh_sharded import WIDE, _mesh
    from torch_mesh_parity import tiny_dv3_trainer

    train, params, opt_states, moments, jdist = tiny_dv3_trainer(XLA + WIDE + [gru], devices=4, mesh=_mesh(1, 2, 2))
    params = condition_two_hot_heads(_numpy_tree(params))
    opt_states, moments = _numpy_tree(opt_states), _numpy_tree(moments)
    T, B = 4, 4
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3), np.uint8),
             "actions": np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))],
             "rewards": rng.standard_normal((1, T, B, 1)).astype(np.float32),
             "terminated": np.zeros((1, T, B, 1), np.float32), "truncated": np.zeros((1, T, B, 1), np.float32),
             "is_first": np.zeros((1, T, B, 1), np.float32)}
    keys = jax.random.split(jax.random.key(7), 1)
    layouts = {
        "replicated": jdist.replicate(jax.tree.map(jnp.asarray, (params, opt_states, moments))),
        "sharded": (jdist.shard_params(jax.tree.map(jnp.asarray, params)),
                    jdist.shard_opt_state(jax.tree.map(jnp.asarray, opt_states)),
                    jdist.replicate(jax.tree.map(jnp.asarray, moments))),
    }
    if not ulp:  # one tree laid out at a time
        layouts["parameters sharded, optimizer state replicated"] = (
            jdist.shard_params(jax.tree.map(jnp.asarray, params)),
            *jdist.replicate(jax.tree.map(jnp.asarray, (opt_states, moments))))
        layouts["optimizer state sharded, parameters replicated"] = (
            jdist.replicate(jax.tree.map(jnp.asarray, params)), jdist.shard_opt_state(jax.tree.map(jnp.asarray,
                                                                                                  opt_states)),
            jdist.replicate(jax.tree.map(jnp.asarray, moments)))
    for seed in range(3 if ulp else 0):
        noise = np.random.default_rng(seed)
        moved = jax.tree.map(lambda x: (x * (1 + 2.0 ** -23 * noise.uniform(-1, 1, x.shape))).astype(x.dtype),
                             params)
        layouts[f"replicated, one ulp moved ({seed})"] = jdist.replicate(
            jax.tree.map(jnp.asarray, (moved, opt_states, moments)))
    for name, placed in layouts.items():
        placed_batch = {k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(2)) for k, v in batch.items()}
        metrics = jax.tree.map(np.asarray, jax.block_until_ready(train(*placed, placed_batch, keys)))[3]
        print(f"{gru}, {name}: " + ", ".join(f"{k.split('/')[-1]} {float(np.mean(v)):.10g}"
                                             for k, v in sorted(metrics.items())), flush=True)


def pieces() -> None:
    """Each world-model method alone (encoder, posterior and prior heads,
    the GRU step, decoder, reward, continue) on the same random inputs with
    the parameters replicated and sharded: the largest gap of each."""
    import gymnasium as gym
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dreamer_tiny import N_ACT, TINY_DV3
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel, build_agent
    from sheeprl_tpu.config import compose
    from sheeprl_tpu.parallel import Distributed
    from test_torch_dreamer_v3 import XLA, _numpy_tree, condition_two_hot_heads
    from test_torch_mesh_sharded import WIDE, _mesh
    from torch_offpolicy import jit_build

    cfg = compose("config", TINY_DV3 + XLA + WIDE + ["algo.world_model.pallas_gru=False"])
    jdist = Distributed(devices=4, mesh=_mesh(1, 2, 2))
    space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    wm, _, _, params = jit_build(lambda k: build_agent(jdist, cfg, space, [N_ACT], False, k), jax.random.key(0))
    params = condition_two_hot_heads(_numpy_tree(params))["wm"]
    placed = {"replicated": jdist.replicate(jax.tree.map(jnp.asarray, params)),
              "sharded": jdist.shard_params(jax.tree.map(jnp.asarray, params))}
    rng = np.random.default_rng(0)
    obs = {"rgb": jnp.asarray(rng.uniform(-0.5, 0.5, (16, 64, 64, 3)).astype(np.float32))}
    h0, z0 = wm.apply({"params": placed["replicated"]}, (16,), method=WorldModel.initial_states)
    za = jnp.concatenate([z0, jnp.asarray(np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, 16)])], -1)
    emb = wm.apply({"params": placed["replicated"]}, obs, method=WorldModel.embed)
    h = jnp.asarray(rng.standard_normal(h0.shape).astype(np.float32))
    latent = jnp.asarray(rng.standard_normal((16, h0.shape[-1] + z0.shape[-1])).astype(np.float32))
    calls = {"embed": (WorldModel.embed, obs), "representation_logits": (WorldModel.representation_logits, emb),
             "recurrent_step": (WorldModel.recurrent_step, za, h0), "transition_logits": (WorldModel.transition_logits, h),
             "decode rgb": (WorldModel.decode, latent), "reward": (WorldModel.reward, latent),
             "cont": (WorldModel.cont, latent)}
    for name, (method, *args) in calls.items():
        a, b = (np.asarray(jax.tree.leaves(jax.jit(lambda p: wm.apply({"params": p}, *args, method=method))(
            placed[k]))[-1], np.float64) for k in ("replicated", "sharded"))
        print(f"{name}: sharded against replicated, largest gap {float(np.abs(a - b).max()):.3e} of the "
              f"largest entry {float(np.abs(a).max()):.4g}", flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    run()
