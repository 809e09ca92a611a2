"""Anakin-mode env fusion: policy and env stepped together as batched tensor
operations (the port's counterpart of ``sheeprl_tpu/fleet/anakin.py``).

The second Podracer layout (arXiv:2104.06272): when the environment itself
is an array program, the fleet's process-per-worker machinery is overhead —
the env step runs beside the policy step over thousands of env lanes at
once, on one device, with no host↔device chatter, no pickling and no socket
frames. The JAX package fuses one chunk into a jitted ``lax.scan``; here one
chunk is a loop of ``chunk`` steps of batched operations on the run's device
(the card for ``run_anakin`` unless ``fabric.accelerator=cpu``, the worker's
CPU inside a fleet worker), launched eagerly.

The env is the repo's synthetic benchmark env — a smooth contractive
state-space system with episodic resets every ``horizon`` steps — and the
policy a small tanh MLP whose parameters ride the publication path of every
fleet program (``set_params`` adopts a publication of the same shapes), so
the program drops into the fleet supervisor unchanged:
``fleet.program=sheeprl_tpu_torch.fleet.anakin:anakin_program``.

Draws: the dynamics, the policy's initial weights and the first states come
from a ``torch.Generator`` seeded with ``seed``; a reset's fresh states from
the same generator through ``reset_rows(t, chunk_index) -> [slots,
obs_dim]``, which a caller may replace (the parity tests pass the JAX
package's draws).

Knobs (all under ``fleet.anakin.*``): ``slots`` (env lanes), ``chunk``
(steps per program ``step()``), ``obs_dim`` / ``act_dim`` / ``hidden``
(synthetic env and policy widths), ``horizon`` (episodic reset period).
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["AnakinEnv", "anakin_program", "build_anakin", "run_anakin"]


def _opt(cfg: Any, path: str, default: Any) -> Any:
    sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)
    v = sel(path, None)
    return default if v is None else v


class AnakinEnv:
    """The synthetic env's dynamics (``A``, ``B``) and the chunk of batched
    steps. ``carry`` is ``(s [slots, obs_dim], t, chunk_index)``: every lane
    starts at ``t = 0`` and steps together, so all lanes reset at once."""

    def __init__(self, A: torch.Tensor, B: torch.Tensor, slots: int, chunk: int, horizon: int,
                 reset_rows: Callable[[int, int], torch.Tensor]) -> None:
        self.A, self.B = A, B
        self.slots, self.chunk, self.horizon = int(slots), int(chunk), int(horizon)
        self.reset_rows = reset_rows

    @staticmethod
    def policy(p: Dict[str, torch.Tensor], s: torch.Tensor) -> torch.Tensor:
        return torch.tanh(torch.addmm(p["b2"], torch.tanh(torch.addmm(p["b1"], s, p["w1"])), p["w2"]))

    @torch.no_grad()
    def run_chunk(self, params: Dict[str, torch.Tensor], carry: Tuple[torch.Tensor, int, int]
                  ) -> Tuple[Tuple[torch.Tensor, int, int], torch.Tensor]:
        """Advance every lane ``chunk`` steps; returns (the carry, the mean
        reward over the chunk as a 0-d tensor on the device)."""
        s, t, c = carry
        r_sum = torch.zeros((), device=s.device)
        for _ in range(self.chunk):
            a = self.policy(params, s)
            s = torch.tanh(s @ self.A + a @ self.B)
            r_sum += s.square().mean()
            t += 1
            if t % self.horizon == 0:
                s = self.reset_rows(t, c).to(s)
        return (s, t, c + 1), -r_sum / self.chunk


def build_anakin(cfg: Any, seed_offset: int = 0, device: Any = "cpu",
                 reset_rows: Optional[Callable[[int, int], torch.Tensor]] = None):
    """Build the env and policy on ``device``: returns ``(params, carry,
    chunk_fn, slots, chunk)`` where ``chunk_fn(params, carry) -> (carry,
    mean_reward)`` advances every lane ``chunk`` steps (``chunk_fn.__self__``
    is the :class:`AnakinEnv`)."""
    slots = int(_opt(cfg, "fleet.anakin.slots", 1024))
    chunk = int(_opt(cfg, "fleet.anakin.chunk", 256))
    obs_dim = int(_opt(cfg, "fleet.anakin.obs_dim", 16))
    act_dim = int(_opt(cfg, "fleet.anakin.act_dim", 4))
    hidden = int(_opt(cfg, "fleet.anakin.hidden", 32))
    horizon = int(_opt(cfg, "fleet.anakin.horizon", 128))
    seed = int(_opt(cfg, "seed", 0)) + int(seed_offset)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device)

    # fixed env dynamics: a contractive linear system + action coupling,
    # squashed — smooth, bounded, and entirely on the device
    A = randn(obs_dim, obs_dim) * (0.9 / math.sqrt(obs_dim))
    B = randn(act_dim, obs_dim) * (1.0 / math.sqrt(act_dim))
    params = {
        "w1": randn(obs_dim, hidden) / math.sqrt(obs_dim),
        "b1": torch.zeros(hidden, device=device),
        "w2": randn(hidden, act_dim) / math.sqrt(hidden),
        "b2": torch.zeros(act_dim, device=device),
    }
    if reset_rows is None:
        def reset_rows(t: int, c: int) -> torch.Tensor:
            return randn(slots, obs_dim)
    env = AnakinEnv(A, B, slots, chunk, horizon, reset_rows)
    carry = (randn(slots, obs_dim), 0, 0)
    return params, carry, env.run_chunk, slots, chunk


def count_ops(fn: Callable[[], Any]) -> int:
    """The operations ``fn()`` dispatches that are not views: each launches
    at least one kernel on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                _Count.n += 1
            return func(*args, **(kwargs or {}))

    with _Count():
        fn()
    return _Count.n


def run_anakin(cfg: Any, min_steps: int = 0, min_seconds: float = 0.0, device: Any = None) -> Dict[str, Any]:
    """Standalone throughput probe: one untimed chunk, then timed chunks
    until both ``min_steps`` env steps and ``min_seconds`` have elapsed. Runs
    on the card unless ``fabric.accelerator=cpu`` (or ``device``). Returns
    ``{env_steps, seconds, steps_per_s, slots, chunk, ops_per_chunk,
    device}``."""
    if device is None:
        from ..utils.utils import get_device

        device = get_device(cfg)
    device = torch.device(device)
    params, carry, chunk_fn, slots, chunk = build_anakin(cfg, device=device)
    ops = count_ops(lambda: chunk_fn(params, carry))  # counted on an untimed chunk
    carry, _ = chunk_fn(params, carry)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    steps = 0
    t0 = time.perf_counter()
    while True:
        carry, mean_r = chunk_fn(params, carry)
        float(mean_r)  # the chunk's end, as the program's step reads it
        steps += slots * chunk
        dt = time.perf_counter() - t0
        if steps >= int(min_steps) and dt >= float(min_seconds):
            break
    return {
        "env_steps": int(steps),
        "seconds": float(dt),
        "steps_per_s": float(steps / max(dt, 1e-9)),
        "slots": int(slots),
        "chunk": int(chunk),
        "ops_per_chunk": int(ops),
        "device": str(device),
    }


def anakin_program(cfg: Any, worker_id: int, num_workers: int) -> Any:
    """Fleet-program wrapper: one ``step()`` = one chunk on the worker's CPU.
    Publications whose leaves match the policy's shapes are adopted
    (anything else — a DV3 snapshot, say — is ignored: Anakin's policy is
    its own small MLP, and the program must survive being driven by any
    learner's publication stream)."""

    class _AnakinProgram:
        sync_params = False

        def __init__(self) -> None:
            self.params, self.carry, self._chunk, self.slots, self.chunk = build_anakin(
                cfg, seed_offset=31 * (int(worker_id) + 1))
            self.lifetime = 0

        def set_params(self, params_np: Any, version: int) -> None:
            from ..serve.policy import tree_leaves

            names = sorted(self.params)
            new = [leaf for _, leaf in tree_leaves(params_np)]
            if len(new) == len(names) and all(
                    tuple(np.shape(b)) == tuple(self.params[k].shape) for k, b in zip(names, new)):
                self.params = {k: torch.as_tensor(np.asarray(b), dtype=torch.float32).clone()
                               for k, b in zip(names, new)}

        def step(self, sink: Any) -> Tuple[int, None]:
            self.carry, mean_r = self._chunk(self.params, self.carry)
            sink.stat("Rewards/rew_avg", float(mean_r))
            n = self.slots * self.chunk
            self.lifetime += n
            return n, None

    return _AnakinProgram()
