"""Plan2Explore-DV3, the finetuning phase, in PyTorch (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py``).

The run inherits the exploration run's ``algo`` settings (``INHERITED``: the
architecture, ``world_model`` with its ``decoupled_rssm`` and
``pallas_gru``, the actor and critic sections and the keys), so a
finetuning override of those is overwritten; the CLI has copied the
exploration run's ``env`` settings and refused another ``env.id``
(``cli.exploration_surgery``). It starts from the exploration checkpoint's
world model, task actor, task critic and its target, exploration actor and
task Moments (``buffer.load_from_exploration``: and its buffer), with fresh
optimizers. The player acts with the exploration actor until
``learning_starts``, then with the task actor for good; the switch follows
the policy step, so a run resumed past ``learning_starts`` acts with the
task actor from its first step. It trains with DreamerV3's
``make_train_fn``: with ``decoupled_rssm=True pallas_gru=True`` on the
LN-GRU kernels (at the XL preset, their streamed instance). The loop is
P2E-DV3's serial loop (``p2e_dv3_exploration.run_serial``).
"""
from __future__ import annotations

import copy
import json
from typing import Any, Dict

from ...config import Config
from ...parallel.layout import ParamLayout
from ...parallel.mesh import collective, maybe_shard_opt_state
from ...parallel.mesh import current as current_distributed
from ...utils.checkpoint import CheckpointManager, param_sums
from ...utils.model_manager import registry_names
from ...utils.registry import register_algorithm
from ..dreamer_v3.agent import build_agent as dv3_build_agent
from ..dreamer_v3.dreamer_v3 import build_optimizers, make_train_fn
from ..dreamer_v3.utils import AGGREGATOR_KEYS, MomentsState
from .p2e_dv3_exploration import LoopParts, run_serial

# the exploration run's algo settings a finetuning run takes
INHERITED = ("gamma", "lmbda", "horizon", "layer_norm", "dense_units", "mlp_layers", "dense_act", "cnn_act",
             "unimix", "hafner_initialization", "world_model", "actor", "critic", "cnn_keys", "mlp_keys")


MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic", "moments"}


def inherit_exploration_algo(cfg: Config, exploration_cfg: Config, keys=INHERITED) -> None:
    """Copy the exploration run's ``algo.<key>`` for each of ``keys`` it
    holds into ``cfg``."""
    for k in keys:
        value = exploration_cfg.select(f"algo.{k}")
        if value is not None:
            cfg.set_path(f"algo.{k}", Config(value.to_dict()) if isinstance(value, Config) else value)


def _setup(cfg: Config, device, precision, obs_space, actions_dim, is_continuous: bool, state) -> LoopParts:
    wm, actor, critic, target_critic = dv3_build_agent(cfg, obs_space, actions_dim, is_continuous, device)
    # the task actor's twin, whose parameters the checkpoint gives
    actor_exploration = copy.deepcopy(actor)
    named = {"wm": wm, "actor": actor, "critic": critic, "target_critic": target_critic,
             "actor_exploration": actor_exploration}
    for m in named.values():
        m.to(precision.param_dtype)  # bf16-true: the parameters themselves are bf16
    dist = collective(cfg)
    optimizers = build_optimizers(cfg, wm, actor, critic, dist)
    rb_state = None
    if state:
        for k, m in named.items():
            m.load_state_dict(state[k])
        for k in ("wm", "actor", "critic"):
            getattr(optimizers, k).optimizer.load_state_dict(state["opt_states"][k])
        optimizers.step = int(state["opt_states"]["step"])
        moments = MomentsState(state["moments"]["low"], state["moments"]["high"])
    else:
        explo = CheckpointManager.load(cfg.checkpoint.exploration_ckpt_path, map_location=device)
        for k, src in (("wm", "wm"), ("actor", "actor_task"), ("critic", "critic_task"),
                       ("target_critic", "target_critic_task"), ("actor_exploration", "actor_exploration")):
            named[k].load_state_dict(explo[src])
        moments = MomentsState(explo["moments"]["task"]["low"], explo["moments"]["task"]["high"])
        if current_distributed(cfg).is_global_zero:
            print("[p2e_dv3_finetuning] from exploration " + json.dumps({
                "checkpoint": str(cfg.checkpoint.exploration_ckpt_path), "param_sums": param_sums(named)}),
                flush=True)
        if cfg.buffer.select("load_from_exploration") and "rb" in explo:
            rb_state = explo["rb"]
    # the optimizer states' layout on the mesh (the parameters stay whole on
    # every rank, as the JAX package leaves them), fresh or resumed alike
    layout = ParamLayout(current_distributed(cfg), named)
    maybe_shard_opt_state(cfg, current_distributed(cfg), layout, {"actor": (optimizers.actor, actor),
                                                                  "critic": (optimizers.critic, critic),
                                                                  "wm": (optimizers.wm, wm)}, counters=("step",))
    train_fn = make_train_fn(wm, actor, critic, target_critic, optimizers, cfg, is_continuous, actions_dim, dist)
    current = {"moments": moments}

    def train(batches, generator):
        current["moments"], metrics = train_fn(current["moments"], batches, generator=generator)
        return metrics

    def algo_state() -> Dict[str, Any]:
        m = current["moments"]
        return {**{k: v.state_dict() for k, v in named.items()},
                "opt_states": {**{k: layout.full_opt_state(getattr(optimizers, k)) for k in ("wm", "actor", "critic")},
                               "step": optimizers.step},
                "moments": {"low": m.low, "high": m.high}}

    def registered() -> Dict[str, Any]:
        m = current["moments"]
        return {**registry_names({k: v for k, v in named.items() if k != "actor_exploration"}),
                "moments": {"low": m.low, "high": m.high}}

    actor_type = str(cfg.algo.player.actor_type)
    return LoopParts(named, train,
                     lambda task_phase: actor if task_phase or actor_type == "task" else actor_exploration,
                     algo_state, actor, AGGREGATOR_KEYS, registered, random_warmup=False, rb_state=rb_state)


@register_algorithm(name="p2e_dv3_finetuning", requires_exploration_cfg=True)
def main(cfg: Config, exploration_cfg: Config) -> None:
    """P2E-DV3's finetuning phase (``run_serial``) from the exploration run
    whose config is ``exploration_cfg``."""
    inherit_exploration_algo(cfg, exploration_cfg)
    run_serial(cfg, "p2e_dv3_finetuning", _setup)
