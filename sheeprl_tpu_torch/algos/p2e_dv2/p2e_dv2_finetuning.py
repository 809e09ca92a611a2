"""Plan2Explore-DV2, the finetuning phase, in PyTorch (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_finetuning.py``).

The run inherits the exploration run's ``algo`` settings (``INHERITED``)
and, through the CLI, its ``env`` settings. It starts from the exploration
checkpoint's world model, task actor, task critic and its target and
exploration actor (``buffer.load_from_exploration``: and its buffer), with
fresh optimizers; acts with the exploration actor until
``learning_starts``, then with the task actor for good (the switch follows
the policy step, so a resumed run past ``learning_starts`` acts with the
task actor from its first step); no random warm-up; and trains with
DreamerV2's ``make_train_fn`` on DreamerV2's serial loop. ``finetune``
is that phase for DreamerV1 too.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Callable, Dict, Sequence

from ...config import Config
from ...utils.checkpoint import CheckpointManager, param_sums
from ...utils.registry import register_algorithm
from ..dreamer_v2.agent import build_agent as dv2_build_agent
from ..dreamer_v2.dreamer_v2 import build_buffer, make_player, make_train_fn, run_serial
from ..dreamer_v2.utils import AGGREGATOR_KEYS as DV2_AGGREGATOR_KEYS
from ..dreamer_v3.dreamer_v3 import LoopParts, build_optimizers
from ..p2e_dv3.p2e_dv3_finetuning import inherit_exploration_algo

INHERITED = ("gamma", "lmbda", "horizon", "layer_norm", "dense_units", "mlp_layers", "dense_act", "cnn_act",
             "world_model", "actor", "critic", "cnn_keys", "mlp_keys")
AGGREGATOR_KEYS = DV2_AGGREGATOR_KEYS | {"Params/exploration_amount_task", "Params/exploration_amount_exploration"}
# the exploration checkpoint's modules a finetuning run starts from
FROM_EXPLORATION = {"wm": "wm", "actor": "actor_task", "critic": "critic_task",
                    "target_critic": "target_critic_task", "actor_exploration": "actor_exploration"}


def finetune(cfg: Config, exploration_cfg: Config, algo: str, build: Callable, train_fn: Callable,
             player_fn: Callable, is_first: bool, buffer_fn: Callable, inherited: Sequence[str],
             aggregator_keys: Any) -> None:
    """The DreamerV1/V2 finetuning phase on ``dreamer_v2.run_serial``:
    ``build``, ``train_fn`` and ``player_fn`` are the plain algorithm's
    (``build`` returns a target critic or None last)."""
    inherit_exploration_algo(cfg, exploration_cfg, inherited)

    def setup(cfg, device, precision, obs_space, actions_dim, is_continuous, state) -> LoopParts:
        wm, actor, critic, target_critic = build(cfg, obs_space, actions_dim, is_continuous, device)
        # the task actor's twin, whose parameters the checkpoint gives
        actor_exploration = copy.deepcopy(actor)
        named = {"wm": wm, "actor": actor, "critic": critic, "actor_exploration": actor_exploration}
        if target_critic is not None:
            named["target_critic"] = target_critic
        for m in named.values():
            m.to(precision.param_dtype)  # bf16-true: the parameters themselves are bf16
        optimizers = build_optimizers(cfg, wm, actor, critic)
        rb_state = None
        if state:
            for k, m in named.items():
                m.load_state_dict(state[k])
            for k in ("wm", "actor", "critic"):
                getattr(optimizers, k).optimizer.load_state_dict(state["opt_states"][k])
            optimizers.step = int(state["opt_states"]["step"])
        else:
            explo = CheckpointManager.load(cfg.checkpoint.exploration_ckpt_path, map_location=device)
            for k, m in named.items():
                m.load_state_dict(explo[FROM_EXPLORATION[k]])
            print(f"[{algo}] from exploration " + json.dumps({
                "checkpoint": str(cfg.checkpoint.exploration_ckpt_path), "param_sums": param_sums(named)}), flush=True)
            if cfg.buffer.select("load_from_exploration") and "rb" in explo:
                rb_state = explo["rb"]
        train = train_fn(*([wm, actor, critic] + ([target_critic] if target_critic is not None else [])),
                         optimizers, cfg, is_continuous, actions_dim)

        def algo_state() -> Dict[str, Any]:
            return {**{k: m.state_dict() for k, m in named.items()},
                    "opt_states": {**{k: getattr(optimizers, k).optimizer.state_dict()
                                      for k in ("wm", "actor", "critic")}, "step": optimizers.step}}

        actor_type = str(cfg.algo.player.actor_type)
        return LoopParts(named, lambda batches, gen: train(batches, generator=gen),
                         lambda task_phase: actor if task_phase or actor_type == "task" else actor_exploration,
                         algo_state, actor, aggregator_keys, random_warmup=False, rb_state=rb_state)

    actor_type = str(cfg.algo.player.actor_type)
    run_serial(cfg, algo, setup, player_fn, is_first, buffer_fn,
               expl_stat=lambda task_phase: "Params/exploration_amount_" + (
                   "task" if task_phase or actor_type == "task" else "exploration"))


@register_algorithm(name="p2e_dv2_finetuning", requires_exploration_cfg=True)
def main(cfg: Config, exploration_cfg: Config) -> None:
    """P2E-DV2's finetuning phase from the exploration run whose config is
    ``exploration_cfg``."""
    finetune(cfg, exploration_cfg, "p2e_dv2_finetuning", dv2_build_agent, make_train_fn, make_player, True,
             build_buffer, INHERITED, AGGREGATOR_KEYS)
