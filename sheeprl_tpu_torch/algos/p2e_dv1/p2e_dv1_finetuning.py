"""Plan2Explore-DV1, the finetuning phase, in PyTorch (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py``): P2E-DV2's
``finetune`` with DreamerV1's agent (no target critic), train step, player,
rows (no ``is_first``) and sequential buffer.
"""
from __future__ import annotations

import functools

from ...config import Config
from ...utils.registry import register_algorithm
from ..dreamer_v1.agent import build_agent as dv1_build_agent
from ..dreamer_v1.dreamer_v1 import make_player, make_train_fn
from ..dreamer_v1.utils import AGGREGATOR_KEYS as DV1_AGGREGATOR_KEYS
from ..dreamer_v2.dreamer_v2 import build_buffer
from ..p2e_dv2.p2e_dv2_finetuning import finetune

INHERITED = ("gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "dense_act", "cnn_act", "world_model",
             "actor", "critic", "cnn_keys", "mlp_keys")
AGGREGATOR_KEYS = DV1_AGGREGATOR_KEYS | {"Params/exploration_amount_task", "Params/exploration_amount_exploration"}

MODELS_TO_REGISTER = {"world_model", "actor", "critic"}


@register_algorithm(name="p2e_dv1_finetuning", requires_exploration_cfg=True)
def main(cfg: Config, exploration_cfg: Config) -> None:
    """P2E-DV1's finetuning phase from the exploration run whose config is
    ``exploration_cfg``."""
    finetune(cfg, exploration_cfg, "p2e_dv1_finetuning", dv1_build_agent, make_train_fn, make_player, False,
             functools.partial(build_buffer, buffer_type="sequential"), INHERITED, AGGREGATOR_KEYS)
