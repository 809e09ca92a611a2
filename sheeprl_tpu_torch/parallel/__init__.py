"""The device mesh, its sharding rules and layouts, and the placement of the
player and the learner (what ``sheeprl_tpu/parallel/__init__.py`` exports,
and the port's own placement helpers)."""

from .layout import ParamLayout
from .mesh import Distributed, build_distributed, maybe_shard_opt_state, maybe_shard_params
from .placement import ParamMirror, make_param_mirror, player_device
from .precision import Precision, get_precision
from .sharding import (DEFAULT_PARAM_RULES, ShardingReport, SpecDecision, SpecEngine, SpecRule, resolve_mesh_shape,
                       spec_str)

__all__ = [
    "Distributed",
    "Precision",
    "build_distributed",
    "get_precision",
    "maybe_shard_opt_state",
    "maybe_shard_params",
    "DEFAULT_PARAM_RULES",
    "ShardingReport",
    "SpecDecision",
    "SpecEngine",
    "SpecRule",
    "resolve_mesh_shape",
    "spec_str",
    "ParamLayout",
    "ParamMirror",
    "make_param_mirror",
    "player_device",
]
