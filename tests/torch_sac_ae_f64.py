"""SAC-AE's Adam moments against optax's on the burst of
``tests/test_torch_sac_ae.py::test_train_burst_matches_jax[xla-2]``
(``conv_impl=xla``, the decoder every second step, a one-step warm-up on
``replay_batch(rng, (1, 4))`` with ``split(PRNGKey(1), 1)``, then G = 3
steps with ``split(PRNGKey(2), 3)``, ``default_rng(5)``): the burst from
the same f32 warm-up state in f32 on one intra-op thread, in f32 at the
process's default thread count, and in f64 on both sides (JAX under
``jax_enable_x64``; the port's modules, states, batches and draws in
float64). Prints, for each run, the largest gap of a moment of the ``qf``,
``actor`` and ``encoder`` optimizers, relative to its tensor's largest entry
(the test's ``MOMENT_RTOL`` units), and the critic loss of both sides.

Usage: ``cd tests && PYTHONPATH=..:. python torch_sac_ae_f64.py`` (about a
minute; each run in a process of its own)."""
import os
import pickle
import subprocess
import sys
import tempfile

G, B = 3, 4
RUNS = ("f32-one-thread", "f32-default-threads", "f64")


def run(mode: str, warm: str) -> None:
    import jax

    if mode == "f64":
        jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from sheeprl_tpu_torch import convert
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import build_optimizers
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import make_train_fn as torch_make_train_fn
    from test_torch_sac_ae import ACT, IMG, STATE, agents, jax_burst, jax_draws
    from torch_offpolicy import numpy_tree, replay_batch, to_torch

    if mode == "f32-one-thread":
        torch.set_num_threads(1)
    jcfg, tcfg, mods, params, agent = agents("xla", ["algo.decoder.per_rank_update_freq=2"])
    spec = {"rgb": IMG, "state": (STATE,)}
    if mode == "f32-one-thread":
        rng = np.random.default_rng(5)
        p1, s1, _ = jax_burst(jcfg, mods, params, None, replay_batch(rng, (1, B), spec, vector_obs=False),
                              jax.random.split(jax.random.PRNGKey(1), 1))
        with open(warm, "wb") as f:
            pickle.dump({"p1": p1, "s1": s1, "batches": replay_batch(rng, (G, B), spec, vector_obs=False)}, f)
    with open(warm, "rb") as f:
        w = pickle.load(f)
    dt = np.float64 if mode == "f64" else np.float32

    def cast(tree):
        return jax.tree.map(lambda x: np.asarray(x).astype(dt) if np.asarray(x).dtype.kind == "f" else np.asarray(x),
                            tree)

    p1, s1, batches = cast(w["p1"]), cast(w["s1"]), cast(w["batches"])
    keys = jax.random.split(jax.random.PRNGKey(2), G)
    p2, s2, j_metrics = jax_burst(jcfg, mods, p1, s1, batches, keys)
    draws = jax_draws(keys, B)
    if mode == "f64":
        torch.set_default_dtype(torch.float64)
        agent = agent.double()
        for m in agent.modules():  # the port casts images to float32 on their way in: keep every layer in f64
            m.register_forward_pre_hook(lambda _, args: tuple(
                x.double() if torch.is_tensor(x) and x.dtype == torch.float32 else x for x in args))
        draws = jax.tree.map(lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x, draws)
    optimizers = build_optimizers(tcfg, agent)
    convert.load_sac_ae(p1, agent, s1, optimizers)
    if mode == "f64":
        for name in ("qf", "actor", "alpha", "encoder", "decoder"):
            for st in optimizers[name].state.values():
                for k, v in st.items():
                    if k != "step" and torch.is_tensor(v) and v.is_floating_point():
                        st[k] = v.double()
    t_metrics = torch_make_train_fn(agent, optimizers, tcfg, -float(ACT), ("rgb",), ("state",))(
        to_torch(batches), draws=draws)
    modules = {"qf": torch.nn.ModuleDict({"encoder": agent.encoder, "qs": agent.qs}), "actor": agent.actor,
               "encoder": agent.encoder}
    gaps = {}
    for name, module in modules.items():
        adam = convert.find_state(numpy_tree(s2[name]))
        refs = {"exp_avg": convert.params_to_state_dict(adam.mu, module),
                "exp_avg_sq": convert.params_to_state_dict(adam.nu, module)}
        for pname, p in module.named_parameters():
            for m, ref in refs.items():
                want = ref[pname].double()
                got = optimizers[name].state[p][m].double()
                gaps[f"{name}:{pname}.{m}"] = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)
    worst = max(gaps, key=gaps.get)
    print(f"{mode}: largest moment gap {gaps[worst]:.3e} of the tensor's largest ({worst}); qf loss port "
          f"{float(t_metrics['Loss/value_loss']):.10f}, JAX {float(np.asarray(j_metrics['Loss/value_loss'])):.10f}",
          flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2:
        run(sys.argv[1], sys.argv[2])
    else:
        with tempfile.TemporaryDirectory() as d:
            warm = os.path.join(d, "warm.pkl")
            for mode in RUNS:  # the later runs read the first one's warm-up state
                subprocess.run([sys.executable, os.path.abspath(__file__), mode, warm], check=True,
                               env={**os.environ, "JAX_PLATFORMS": "cpu"})
