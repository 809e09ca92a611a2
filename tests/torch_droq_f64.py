"""DroQ's actor Adam moments against optax's on the draw of ROADMAP Queue 3
item 14 (dropout 0.0, a one-step warm-up on ``replay_batch(rng, (1, 8))``
with ``split(PRNGKey(1), 1)`` and ``PRNGKey(9)``, then G = 2 critic steps
with ``split(PRNGKey(2), 2)`` and the actor step with ``PRNGKey(3)``,
``default_rng(5)``), once in f32 as ``tests/test_torch_droq.py`` runs it and
once in f64 on both sides (JAX under ``jax_enable_x64``, the port's modules,
states and draws in float64) from the same f32 warm-up state. Prints the
largest gap of each actor moment, relative to its tensor's largest entry,
and the policy losses.

Usage: ``cd tests && PYTHONPATH=..:. python torch_droq_f64.py`` (about a
minute; each precision in a process of its own)."""
import os
import pickle
import subprocess
import sys
import tempfile

B, G = 8, 2


def run(mode: str, warm: str) -> None:
    import jax

    if mode == "f64":
        jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    import torch_offpolicy as O
    from sheeprl_tpu_torch import convert
    from sheeprl_tpu_torch.algos.droq.droq import make_train_fn as torch_make_train_fn
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
    from test_torch_droq import LAYERS, N, agents, jax_burst, jax_draws

    jcfg, tcfg, actor, critic, params, agent = agents(["algo.critic.dropout=0.0"])
    if mode == "f32":
        rng = np.random.default_rng(5)
        p1, s1, _ = jax_burst(jcfg, actor, critic, params, None, O.replay_batch(rng, (1, B)),
                              O.replay_batch(rng, (B,)), jax.random.split(jax.random.PRNGKey(1), 1),
                              jax.random.PRNGKey(9))
        with open(warm, "wb") as f:
            pickle.dump({"p1": p1, "s1": s1, "cb": O.replay_batch(rng, (G, B)), "ab": O.replay_batch(rng, (B,))}, f)
    with open(warm, "rb") as f:
        w = pickle.load(f)
    dt = np.float64 if mode == "f64" else np.float32

    def cast(tree):
        return jax.tree.map(lambda x: np.asarray(x).astype(dt) if np.asarray(x).dtype.kind == "f" else np.asarray(x),
                            tree)

    p1, s1, cb, ab = cast(w["p1"]), cast(w["s1"]), cast(w["cb"]), cast(w["ab"])
    keys, actor_key = jax.random.split(jax.random.PRNGKey(2), G), jax.random.PRNGKey(3)
    p2, s2, j_metrics = jax_burst(jcfg, actor, critic, p1, s1, cb, ab, keys, actor_key)
    if mode == "f64":
        torch.set_default_dtype(torch.float64)
        agent = agent.double()
    optimizers = build_optimizers(tcfg, agent)
    convert.load_droq(p1, agent, s1, optimizers)
    draws = jax_draws(keys, actor_key, [np.ones((B, 32), bool)] * (N * LAYERS * (2 * G + 1)), B)
    if mode == "f64":
        for name in ("actor", "critic", "alpha"):
            for st in optimizers[name].state.values():
                for k, v in st.items():
                    if k != "step" and torch.is_tensor(v) and v.is_floating_point():
                        st[k] = v.double()
        draws = jax.tree.map(lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x, draws)
    t_metrics = torch_make_train_fn(agent, optimizers, tcfg, -float(O.ACT))(O.to_torch(cb), O.to_torch(ab),
                                                                           draws=draws)
    adam = convert.find_state(s2["actor"])
    refs = {"exp_avg": convert.params_to_state_dict(O.numpy_tree(adam.mu), agent.actor),
            "exp_avg_sq": convert.params_to_state_dict(O.numpy_tree(adam.nu), agent.actor)}
    gaps = {}
    for name, p in agent.actor.named_parameters():
        for m, ref in refs.items():
            want = ref[name].double()
            gaps[f"{name}.{m}"] = float((optimizers["actor"].state[p][m].double() - want).abs().max()) / max(
                float(want.abs().max()), 1e-300)
    worst = max(gaps, key=gaps.get)
    print(f"{mode}: actor moments, largest gap {gaps[worst]:.3e} of the tensor's largest ({worst}); policy loss "
          f"port {float(t_metrics['Loss/policy_loss']):.10f}, JAX {float(np.asarray(j_metrics['Loss/policy_loss'])):.10f}",
          flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2:
        run(sys.argv[1], sys.argv[2])
    else:
        with tempfile.TemporaryDirectory() as d:
            warm = os.path.join(d, "warm.pkl")
            for mode in ("f32", "f64"):  # the f64 process reads the f32 one's warm-up state
                subprocess.run([sys.executable, os.path.abspath(__file__), mode, warm], check=True,
                               env={**os.environ, "JAX_PLATFORMS": "cpu"})
