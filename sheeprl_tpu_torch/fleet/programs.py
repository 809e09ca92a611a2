"""Worker-side acting programs of the fleet (the port's counterpart of
``sheeprl_tpu/fleet/programs.py``).

A *program* is what a fleet worker process runs between packets: it owns
the worker's env slice and its CPU policy, and replays the env-interaction
logic of the algorithm's serial loop — restricted to ``envs_per_worker``
columns — into the packet's ``RecordingSink``. Heavy imports happen inside
the builders: this module is imported BY PATH inside the worker process (the
spawn args stay picklable strings), and the learner imports it only for the
numpy-only ``merge_ppo_round``.

Seeding contract: worker ``w`` builds env columns ``[w·epw, (w+1)·epw)``
with the *same per-env seeds* the serial loop's ``vectorize`` gives those
columns, so the env streams are identical modulo action divergence. Its
policy draws come from its own generators, seeded from ``seed + 977·(w+1)``
(one per env slot for the step programs, ``act_core.slot_generators``).

Under ``fleet.act_mode=inference`` the SAC and DreamerV3 programs still
draw every slot's noise from the slot's generator, but ship ``(obs, noise,
reset)`` to the learner's batched act service (``fleet/act_service.py``,
through the channel's ``act_request``) and take back ``actions`` and
``actions_cat``; the DreamerV3 latents then live in the service.

Programs expose:

* ``sync_params`` — False for the off-policy step programs (act with the
  newest snapshot available, stale is fine), True for PPO (exactly one
  rollout per publication: the strict on-policy round protocol);
* ``set_params(params_np, version)``;
* ``step(sink) -> (env_steps, payload_or_None)`` — None means "the sink is
  the payload".
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["dreamer_v3_program", "merge_ppo_round", "ppo_program", "sac_program", "worker_seed"]


def _slice_cfg(cfg: Any, epw: int) -> Any:
    """The worker's view of the run config: its env slice, no videos (the
    learner owns logging)."""
    from ..config import Config

    return Config({**cfg.to_dict(), "env": {**cfg.env.to_dict(), "num_envs": int(epw), "capture_video": False}})


def _slice_seed(cfg: Any, worker_id: int, epw: int) -> int:
    # the serial vectorize seeds env i with `seed + rank*num_envs + i`; the
    # fleet is one controller, so column w*epw+j gets seed + w*epw + j
    return int(cfg.seed) + worker_id * epw


def worker_seed(cfg: Any, worker_id: int) -> int:
    """The seed of worker ``worker_id``'s policy draws."""
    return int(cfg.seed) + 977 * (worker_id + 1)


def _random_actions(action_space: Any, n: int) -> np.ndarray:
    return np.stack([action_space.sample() for _ in range(n)])


def _act_mode(cfg: Any) -> str:
    mode = str(cfg.select("fleet.act_mode", "worker") or "worker")
    if mode not in ("worker", "inference"):
        raise ValueError(f"fleet.act_mode must be worker | inference, got {mode!r}")
    return mode


def _act_timeout(cfg: Any) -> float:
    v = cfg.select("fleet.act.timeout_s", None)
    return float(30.0 if v is None else v)


def _host_noise(noise: Any) -> Any:
    """A core's noise draw (tensors, or a dict / list of them) as numpy."""
    from ..serve.policy import tree_map

    return tree_map(lambda t: t.numpy(), noise)


def _remote_act(program: Any, req: Dict[str, Any]) -> Dict[str, Any]:
    """Ship one act request through the worker's channel (Sebulba mode) and
    block for the batched response, emitting the `act_submit` span the
    service's `act_infer` joins. The channel is injected by the worker loop
    (``act_transport`` / ``act_identity``); request ids are a
    per-incarnation counter, so the service's idempotency cache tells a
    retry from a new request."""
    from ..telemetry import tracing

    transport = getattr(program, "act_transport", None)
    identity = getattr(program, "act_identity", None)
    if transport is None or identity is None:
        raise RuntimeError("fleet.act_mode=inference requires the worker loop's act transport "
                           "(program ran outside fleet_worker_loop?)")
    program._act_seq = int(getattr(program, "_act_seq", 0)) + 1
    ctx = tracing.TraceContext(tracing.new_trace_id(), tracing.new_span_id())
    req = dict(req)
    req["worker_id"] = int(identity[0])
    req["incarnation"] = int(identity[1])
    req["req_id"] = int(program._act_seq)
    req["trace"] = (ctx.trace_id, ctx.span_id)
    t0 = time.time()
    resp = transport.act_request(req, timeout_s=float(getattr(program, "act_timeout_s", 30.0)),
                                 beat=getattr(program, "beat", None))
    emit = getattr(program, "trace_emit", None)
    if emit is not None:
        emit(tracing.span_record("act_submit", "worker", ctx, t0, time.time(), worker=req["worker_id"],
                                 seq=req["req_id"], version=int(resp.get("version", 0) or 0)))
    if resp.get("error"):
        raise RuntimeError(f"act service error: {resp['error']}")
    return resp


# ---------------------------------------------------------------------------
# SAC — one vector step per packet (uniform fixed-width replay; concat merge)
# ---------------------------------------------------------------------------
def sac_program(cfg: Any, worker_id: int, num_workers: int) -> Any:
    from ..algos.sac.sac import transition
    from ..algos.sac.utils import flatten_obs
    from ..utils.env import episode_stats, vectorize
    from .act_core import build_act_core, slot_generators

    class _SacProgram:
        sync_params = False

        def __init__(self) -> None:
            self.epw = int(cfg.env.num_envs) // int(num_workers)
            self.num_workers = int(num_workers)
            self.envs = vectorize(_slice_cfg(cfg, self.epw), _slice_seed(cfg, worker_id, self.epw), 0)
            self.action_space = self.envs.single_action_space
            self.mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
            self.act_dim = int(np.prod(self.action_space.shape))
            self.validate = bool(cfg.buffer.validate_args)
            self.learning_starts = int(cfg.algo.learning_starts) if not cfg.dry_run else 0
            self.core = build_act_core("sac", cfg, self.envs.single_observation_space, self.action_space)
            self.gens = slot_generators(worker_seed(cfg, worker_id), self.epw)
            self.act_mode = _act_mode(cfg)
            self.act_timeout_s = _act_timeout(cfg)
            self.params: Any = None
            obs, _ = self.envs.reset(seed=_slice_seed(cfg, worker_id, self.epw))
            self.obs_vec = flatten_obs(obs, self.mlp_keys, self.epw)
            self.lifetime = 0

        def set_params(self, params_np: Any, version: int) -> None:
            # inference mode acts through the learner's service: the
            # publication only opens the warm-up gate here
            self.params = params_np if self.act_mode == "inference" else self.core.extract_params(params_np)

        def step(self, sink: Any) -> Tuple[int, None]:
            epw = self.epw
            # global-step estimate at round granularity: every worker is at
            # the same per-slice count when rounds are full-strength
            if self.params is None or self.lifetime * self.num_workers <= self.learning_starts:
                actions = _random_actions(self.action_space, epw)
            elif self.act_mode == "inference":
                resp = _remote_act(self, {"n": epw, "obs": self.obs_vec,
                                          "noise": _host_noise(self.core.draw_noise(self.gens))})
                actions = np.asarray(resp["actions"]).reshape(epw, self.act_dim)
            else:
                acts, _, _ = self.core.act(self.params, self.obs_vec, self.core.draw_noise(self.gens))
                actions = acts.numpy().reshape(epw, self.act_dim)
            next_obs, rewards, terminated, truncated, info = self.envs.step(actions)
            self.lifetime += epw
            row, self.obs_vec = transition(self.obs_vec, next_obs, actions, rewards, terminated, truncated, info,
                                           self.mlp_keys, epw)
            sink.add(row, validate_args=self.validate)
            for ep_rew, ep_len in episode_stats(info):
                sink.stat("Rewards/rew_avg", ep_rew)
                sink.stat("Game/ep_len_avg", ep_len)
            return epw, None

    return _SacProgram()


# ---------------------------------------------------------------------------
# DreamerV3 — one vector step per packet (per-env sequential replay; sliced
# merge: each worker's ops replay against its own global env columns)
# ---------------------------------------------------------------------------
def dreamer_v3_program(cfg: Any, worker_id: int, num_workers: int) -> Any:
    import torch

    from ..algos.dreamer_v3.dreamer_v3 import DV3Stepper, _actions_dim
    from ..envs import spaces
    from ..utils.env import vectorize
    from .act_core import build_act_core, slot_generators

    class _Player:
        """The stepper's player on the act core: per-slot noise, and the
        core's CPU modules in place of a mirror."""

        def __init__(self, core: Any, gens: Any) -> None:
            self.core, self.gens, self.params = core, gens, None

        def current(self) -> Any:
            return self.params

        def init(self, mask=None, state=None, modules=None):
            if modules is None:  # no publication yet: the stepper acts at random
                return None
            if state is None or mask is None:
                return self.core.init_state(modules, len(self.gens))
            return self.core.reset_state(modules, mask, state)

        def step(self, obs, state, generator=None, modules=None, mask=None):
            return self.core.act(modules, obs, self.core.draw_noise(self.gens), state, mask)

    class _RemotePlayer(_Player):
        """The stepper's player under ``fleet.act_mode=inference``: the
        latents live in the learner's act service, keyed by (worker, slot).
        Its state here is the mask of slots whose latent starts anew on the
        next request (all at first, then dones and restarts), cleared only
        after a round trip succeeds: a failed act crashes this incarnation,
        and its respawn starts from a full mask."""

        def __init__(self, core: Any, gens: Any, program: Any) -> None:
            super().__init__(core, gens)
            self.program = program

        def init(self, mask=None, state=None, modules=None):
            if modules is None:
                return None
            if state is None or mask is None:
                return np.ones((len(self.gens),), bool)
            return state | np.asarray(mask, bool).reshape(-1)

        def step(self, obs, state, generator=None, modules=None, mask=None):
            n = len(self.gens)
            req: Dict[str, Any] = {"n": n, "obs": obs, "noise": _host_noise(self.core.draw_noise(self.gens))}
            if mask is not None:
                req["mask"] = mask
            if state.any():
                req["reset"] = state.copy()
            resp = _remote_act(self.program, req)
            return (torch.from_numpy(np.asarray(resp["actions"])), torch.from_numpy(np.asarray(resp["actions_cat"])),
                    np.zeros((n,), bool))

    class _DreamerProgram:
        sync_params = False

        def __init__(self) -> None:
            self.epw = int(cfg.env.num_envs) // int(num_workers)
            self.num_workers = int(num_workers)
            wcfg = _slice_cfg(cfg, self.epw)
            seed = _slice_seed(cfg, worker_id, self.epw)
            envs = vectorize(wcfg, seed, 0, restart_handled_by_loop=True)
            action_space = envs.single_action_space
            self.core = build_act_core("dreamer_v3", cfg, envs.single_observation_space, action_space)
            gens = slot_generators(worker_seed(cfg, worker_id), self.epw)
            self.act_mode = _act_mode(cfg)
            self.act_timeout_s = _act_timeout(cfg)
            self.player = _RemotePlayer(self.core, gens, self) if self.act_mode == "inference" else _Player(
                self.core, gens)
            learning_starts = int(cfg.algo.learning_starts) if not cfg.dry_run else 0
            # the serial loop's stepper on this slice (it resets the envs with
            # the slice's seed); its warm-up gate reads the global-step
            # estimate lifetime * num_workers at round granularity
            wcfg["seed"] = seed
            self.stepper = DV3Stepper(wcfg, envs, _actions_dim(action_space), isinstance(action_space, spaces.Box),
                                      self.player.init, self.player.step, None, self.player, 0, learning_starts)
            self.learning_starts = learning_starts
            self.lifetime = 0

        def set_params(self, params_np: Any, version: int) -> None:
            # inference mode acts through the learner's service: the
            # publication only opens the warm-up gate here
            self.player.params = params_np if self.act_mode == "inference" else self.core.extract_params(params_np)

        def step(self, sink: Any) -> Tuple[int, None]:
            p_step = self.stepper.p_step = self.lifetime * self.num_workers
            # before the first publication the stepper acts at random (its
            # player state waits for parameters)
            self.stepper.learning_starts = self.learning_starts if self.player.params is not None else p_step
            self.stepper(sink)
            self.lifetime += self.epw
            return self.epw, None

    return _DreamerProgram()


# ---------------------------------------------------------------------------
# PPO — one ROLLOUT per packet, strictly one rollout per publication
# ---------------------------------------------------------------------------
def ppo_program(cfg: Any, worker_id: int, num_workers: int) -> Any:
    import torch

    from ..algos.ppo.agent import build_agent
    from ..algos.ppo.ppo import bootstrap_truncated, make_act_fn, make_value_fn
    from ..algos.ppo.utils import env_actions, prepare_obs
    from ..envs import spaces
    from ..utils.env import episode_stats, vectorize
    from .act_core import load_modules

    class _PpoProgram:
        sync_params = True  # exactly one rollout per param publication

        def __init__(self) -> None:
            self.epw = int(cfg.env.num_envs) // int(num_workers)
            self.envs = vectorize(_slice_cfg(cfg, self.epw), _slice_seed(cfg, worker_id, self.epw), 0)
            self.obs_space = self.envs.single_observation_space
            self.action_space = self.envs.single_action_space
            self.cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
            self.mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
            self.obs_keys = self.cnn_keys + self.mlp_keys
            self.rollout_steps = int(cfg.algo.rollout_steps)
            self.gamma = float(cfg.algo.gamma)
            self.multi = isinstance(self.action_space, spaces.MultiDiscrete)
            self.agent = build_agent(cfg, self.obs_space, self.action_space, torch.device("cpu"))
            self.agent.requires_grad_(False)
            self._act, self._value = make_act_fn(), make_value_fn()
            self.gen = torch.Generator().manual_seed(worker_seed(cfg, worker_id))
            self.params: Any = None
            self.obs, _ = self.envs.reset(seed=_slice_seed(cfg, worker_id, self.epw))

        def set_params(self, params_np: Any, version: int) -> None:
            load_modules({"agent": self.agent}, params_np)
            self.params = version

        def prepare(self, obs: Dict[str, np.ndarray], n: int) -> Dict[str, Any]:
            return prepare_obs(obs, self.cnn_keys, self.mlp_keys, n)

        def step(self, sink: Any) -> Tuple[int, Any]:
            epw, agent = self.epw, self.agent
            rows: Dict[str, List[np.ndarray]] = {}
            ep_stats: List[Tuple[float, float]] = []
            # one slice = a whole rollout: pulse the worker heartbeat between
            # env steps so a slow rollout is never mistaken for a hang
            beat = getattr(self, "beat", None) or (lambda: None)
            for _ in range(self.rollout_steps):
                beat()
                actions, logprobs, values = self._act(agent, self.prepare(self.obs, epw), generator=self.gen)
                np_actions = actions.numpy()
                next_obs, rewards, terminated, truncated, info = self.envs.step(
                    env_actions(np_actions, agent.is_continuous, epw, self.multi))
                rewards = np.asarray(rewards, np.float32).reshape(epw, 1)
                dones = np.logical_or(terminated, truncated).astype(np.float32).reshape(epw, 1)
                bootstrap_truncated(rewards, truncated, info, self.obs_keys,
                                    lambda o, idx: self._value(agent, self.prepare(o, len(idx))).numpy(), self.gamma)
                step_data = {f"obs:{k}": np.asarray(self.obs[k]).reshape(1, epw, *self.obs_space[k].shape)
                             for k in self.obs_keys}
                step_data["actions"] = np_actions.reshape(1, epw, -1).astype(np.float32)
                step_data["logprobs"] = logprobs.numpy().reshape(1, epw, 1)
                step_data["values"] = values.numpy().reshape(1, epw, 1)
                step_data["rewards"] = rewards.reshape(1, epw, 1)
                step_data["dones"] = dones.reshape(1, epw, 1)
                for k, v in step_data.items():
                    rows.setdefault(k, []).append(v)
                self.obs = next_obs
                ep_stats.extend(episode_stats(info))
            local = {k: np.concatenate(v, axis=0) for k, v in rows.items()}
            next_value = self._value(agent, self.prepare(self.obs, epw)).numpy()
            return self.rollout_steps * epw, (local, next_value, ep_stats)

    return _PpoProgram()


def merge_ppo_round(rnd: Any, num_workers: int) -> Tuple[Dict[str, np.ndarray], np.ndarray, List[Any]]:
    """Learner-side merge of one PPO fleet round into the full-width
    ``[T, num_envs, ...]`` rollout (+ bootstrap values). Quarantined slots
    are backfilled by duplicating surviving workers' slices — shapes never
    change; their episode stats are not double-counted."""
    by = {p.worker_id: p.payload for p in rnd.packets}
    present = sorted(by)
    locals_: List[Dict[str, np.ndarray]] = []
    next_vals: List[np.ndarray] = []
    ep_stats: List[Any] = []
    for slot in range(int(num_workers)):
        src = by[slot] if slot in by else by[present[slot % len(present)]]
        locals_.append(src[0])
        next_vals.append(np.asarray(src[1]).reshape(-1, 1))
        if slot in by:
            ep_stats.extend(src[2])
    local = {k: np.concatenate([l[k] for l in locals_], axis=1) for k in locals_[0]}
    next_value = np.concatenate(next_vals, axis=0)
    return local, next_value, ep_stats
