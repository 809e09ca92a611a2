"""Evaluation on top of `InferencePolicy` (the port's counterpart of
``sheeprl_tpu/serve/evaluate.py``).

PPO's and SAC's registered evaluations go through the same
checkpoint→policy path the server uses, so a policy that evaluates is a
policy that serves (and the other way round — one adapter to keep correct).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .policy import InferencePolicy, env_action


def run_policy_episode(
    policy: InferencePolicy,
    env: Any,
    cfg: Any,
    logger: Any = None,
    deterministic: bool = True,
    session: Optional[str] = "eval",
) -> float:
    """One greedy episode through the single-request act path (the same
    prepare→bucket→apply pipeline serving traffic takes)."""
    done = False
    cumulative_rew = 0.0
    obs, _ = env.reset(seed=int(cfg.seed))
    while not done:
        actions = policy.act(obs, deterministic=deterministic, session=session)
        obs, reward, terminated, truncated, _ = env.step(env_action(actions[0], env.action_space))
        done = bool(terminated or truncated)
        cumulative_rew += float(reward)
        if cfg.get("dry_run", False):
            done = True
    if session is not None:
        policy.sessions.drop(session)
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    print(f"Test - Reward: {cumulative_rew}", flush=True)
    env.close()
    return cumulative_rew


def evaluate_with_policy(cfg: Any, state: Dict[str, Any]) -> float:
    """Shared body of the registered evaluations: checkpoint state → policy
    on the serving device → one greedy episode."""
    import torch

    from ..utils.env import single_env

    env = single_env(cfg, int(cfg.seed))
    torch.manual_seed(int(cfg.seed))
    policy = InferencePolicy.from_state(cfg, state, env.observation_space, env.action_space)
    print(f"[eval] {cfg.algo.name} through serve/evaluate.py (InferencePolicy on {policy.device})", flush=True)
    return run_policy_episode(policy, env, cfg)
