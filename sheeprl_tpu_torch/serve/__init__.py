"""Batched policy serving on the card: checkpoint → micro-batched inference
(+hot reload), the port's counterpart of ``sheeprl_tpu/serve/``.

    from sheeprl_tpu_torch.serve import serve_from_checkpoint
    server = serve_from_checkpoint("…/ckpt_1024.ckpt", cfg, block=False)
    actions = server.act({"state": obs_vec})
"""
from .batcher import Backpressure, MicroBatcher, ServeStats, jittered_retry_after
from .policy import (
    InferencePolicy,
    PolicyCore,
    SessionExpired,
    SessionStore,
    env_action,
    register_policy_builder,
)
from .reload import CheckpointReloader
from .server import PolicyServer, serve_from_checkpoint
from .session_codec import StateDecodeError, decode_state, encode_state

__all__ = [
    "Backpressure",
    "CheckpointReloader",
    "InferencePolicy",
    "MicroBatcher",
    "PolicyCore",
    "PolicyServer",
    "ServeStats",
    "SessionExpired",
    "SessionStore",
    "StateDecodeError",
    "decode_state",
    "encode_state",
    "env_action",
    "jittered_retry_after",
    "register_policy_builder",
    "serve_from_checkpoint",
]
