"""The fine-tune recipe: ingest → gradient burst → checkpoint → rolling reload
(the port's counterpart of ``sheeprl_tpu/flywheel/recipe.py``).

`run_flywheel` is the ``sheeprl_tpu_torch flywheel run_dir=... checkpoint_path=...``
entrypoint's workhorse — one turn of the data flywheel:

1. **ingest** the run's capture segments into a replay buffer
   (flywheel/ingest.py: exactly-once via the persisted ledger, torn-tail
   tolerant, every sample stamped with the ``params_version`` that produced
   it);
2. **staleness gate** — ``flywheel.max_version_lag``: samples from a policy
   more than that many versions behind the serving one are dropped (and
   counted) instead of training the new policy on ancient behavior;
3. **fine-tune** ``flywheel.steps`` gradient steps on the mixed
   served+fresh buffer through a registered per-algo finetune step
   (``FINETUNE_BUILDERS`` — the flywheel analogue of the serve stack's
   ``POLICY_BUILDERS``);
4. **checkpoint** the updated params as ``ckpt_<step+N>.ckpt`` beside the
   served checkpoint: a ``torch.save`` through the port's atomic checkpoint
   writer (tmp+fsync+replace, ``utils/checkpoint.py``), so a reloader never
   sees a torn file and the port's ``CheckpointReloader`` and
   ``CheckpointManager.load_for_inference`` read it (the JAX package
   pickles);
5. **rolling reload** — push the new checkpoint through the gateway's
   existing drain-one-replica-at-a-time path (``POST
   /admin/rolling_reload``, or an in-process manager handle for tests and
   the bench); replicas that poll their own checkpoint dir pick it up on
   the next poll even without a gateway.

Finetune steps are deliberately pluggable: the registered
``synthetic_counter`` step (the gateway's chaos/bench policy) proves the
loop mechanics end to end without a training run, exactly like the serve
and gateway test fleets do; real algos register their own step, or a caller
with a built :class:`~sheeprl_tpu_torch.serve.policy.PolicyCore` passes it as
``run_flywheel(..., core=...)`` to get the generic greedy-BC step
(continuous actions only — it differentiates the deterministic apply
against the captured actions, on the core's device).
"""
from __future__ import annotations

import json
import pathlib
import time
import urllib.request
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..fleet.net import _emit
from .ingest import IngestLedger, ingest

__all__ = [
    "FINETUNE_BUILDERS",
    "register_finetune_builder",
    "run_flywheel",
    "write_checkpoint",
]

# algo name -> builder(cfg) -> step_fn(params, batch, key) -> (params, metrics)
FINETUNE_BUILDERS: Dict[str, Callable] = {}


def register_finetune_builder(*names: str) -> Callable:
    def wrap(fn: Callable) -> Callable:
        for name in names:
            if name in FINETUNE_BUILDERS:
                raise ValueError(f"Finetune builder for '{name}' already registered")
            FINETUNE_BUILDERS[name] = fn
        return fn

    return wrap


@register_finetune_builder("synthetic_counter")
def _synthetic_counter_finetune(cfg: Any = None) -> Callable:
    """The synthetic counter policy's 'fine-tune': nudge the (unused-by-act)
    weight by the batch's mean reward. Zero model content by design — what
    it proves is the LOOP: ingested experience moves the params, the new
    checkpoint rolls through the gateway, and the served ``params_version``
    bumps without dropping an acked request."""
    lr = float(_sel(cfg, "flywheel.lr", 0.01))

    def step(params: Dict[str, Any], batch: Dict[str, np.ndarray], key: Any = None):
        rewards = np.asarray(batch.get("rewards", np.zeros((1,), np.float32)), np.float32)
        delta = lr * (1.0 + float(np.mean(rewards)))
        new = dict(params)
        new["w"] = np.asarray(params["w"], np.float32) + np.float32(delta)
        return new, {"loss": float(-np.mean(rewards)), "delta": delta}

    return step


def _sel(cfg: Any, path: str, default: Any) -> Any:
    if cfg is None:
        return default
    if hasattr(cfg, "select"):
        val = cfg.select(path, default)
        return default if val is None else val
    return default


_BATCH_KEYS = ("actions", "rewards", "dones", "params_version", "capture_step")


def _bc_finetune(core: Any, cfg: Any = None) -> Callable:
    """Generic greedy behavior cloning against the captured actions: only
    valid when the deterministic apply is differentiable w.r.t. params
    (continuous-action policies — a gaussian mean head). Discrete argmax
    policies need their own registered finetune step.

    One step: the batch's observation leaves go through ``core.prepare``
    onto the core's device, the gradient of the mean squared error between
    ``core.apply(params, obs, None, noise, True)`` and the captured actions
    is taken with respect to every tensor of the ``params`` tree, and the
    tensors are stepped by SGD at ``flywheel.lr``. The loss is read to the
    host once a step; an explicit ``torch.Generator`` (``flywheel.seed``)
    supplies any noise the core draws. The returned tree holds device
    tensors (``write_checkpoint`` stores host copies)."""
    import torch

    from ..serve.policy import tree_leaves, tree_map

    lr = float(_sel(cfg, "flywheel.lr", 1e-4))
    device = torch.device(core.device)
    generator = torch.Generator(device=device).manual_seed(int(_sel(cfg, "flywheel.seed", 0)))
    first: Dict[str, float] = {}

    def to_leaf(x: Any) -> torch.Tensor:
        t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if not t.is_floating_point():  # counters and the like: carried, never stepped
            return t.to(device)
        return t.to(device=device, dtype=torch.float32).requires_grad_(True)

    def to_obs(x: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(device)

    def step(params, batch, key=None):
        raw = {k: v for k, v in batch.items() if k not in _BATCH_KEYS}
        n = int(np.asarray(batch["actions"]).shape[0])
        obs = tree_map(to_obs, core.prepare(raw, n))
        actions = torch.as_tensor(np.asarray(batch["actions"], np.float32)).to(device)
        leaves = tree_map(to_leaf, params)
        trained = [t for _, t in tree_leaves(leaves) if t.requires_grad]
        with torch.enable_grad():
            pred, _ = core.apply(leaves, obs, None, core.draw_noise(generator, n), True)
            loss = torch.mean((pred.to(torch.float32).reshape(actions.shape) - actions) ** 2)
            grads = torch.autograd.grad(loss, trained, allow_unused=True)
        grad_of = {id(t): g for t, g in zip(trained, grads) if g is not None}
        with torch.no_grad():
            new = tree_map(lambda t: (t - lr * grad_of[id(t)] if id(t) in grad_of else t).detach(), leaves)
        value = float(loss.detach())  # the step's one read to the host
        first.setdefault("loss", value)
        return new, {"loss": value, "first_loss": first["loss"], "device": str(device)}

    return step


def build_finetune_step(algo: str, cfg: Any = None, core: Any = None) -> Callable:
    if algo in FINETUNE_BUILDERS:
        return FINETUNE_BUILDERS[algo](cfg)
    if core is not None:
        return _bc_finetune(core, cfg)
    raise ValueError(
        f"No finetune builder registered for '{algo}' and no policy core to fall "
        f"back on. Available: {sorted(FINETUNE_BUILDERS)} — register one with "
        "sheeprl_tpu_torch.flywheel.recipe.register_finetune_builder."
    )


def write_checkpoint(ckpt_dir: Any, step: int, payload: Dict[str, Any]) -> str:
    """Atomic ``ckpt_<step>.ckpt`` write with the CheckpointManager contract:
    a host copy of the payload ``torch.save``d to a tmp file, fsync, rename
    into place, fsync of the directory — a hot-reload poll that sees the
    file sees the whole file."""
    from ..utils.checkpoint import save_atomic, snapshot

    path = pathlib.Path(ckpt_dir) / f"ckpt_{int(step)}.ckpt"
    save_atomic(path, snapshot(payload))
    return str(path)


def _loaded_step(ckpt_path: pathlib.Path) -> int:
    try:
        return int(ckpt_path.stem.split("_")[1])
    except (IndexError, ValueError):
        return 0


def _resolve_serving_version(cfg: Any) -> Optional[int]:
    """What the serving plane is running RIGHT NOW — the reference point
    the staleness gate and the ``version_lag`` telemetry measure against.
    ``flywheel.serving_version`` wins when set (offline reprocessing with a
    known target); otherwise the gateway's health view is probed
    (``params_version_max`` across routable replicas); with neither, None —
    ingest falls back to the newest version observed in the backlog (lag is
    then measured WITHIN the backlog only, documented on the knob)."""
    explicit = _sel(cfg, "flywheel.serving_version", None)
    if explicit is not None:
        return int(explicit)
    gateway_url = _sel(cfg, "flywheel.gateway_url", None)
    if gateway_url:
        try:
            with urllib.request.urlopen(
                f"{str(gateway_url).rstrip('/')}/healthz", timeout=5.0
            ) as resp:
                health = json.loads(resp.read())
            version = health.get("params_version_max")
            if version is not None and int(version) >= 0:
                return int(version)
        except Exception:
            pass  # an unreachable gateway degrades to backlog-relative lag
    return None


def _trigger_reload(
    gateway_url: Optional[str], rolling_reload: Optional[Callable]
) -> Dict[str, Any]:
    """Push the new checkpoint through the rolling-reload path: an
    in-process manager hook (tests, the bench) wins over an HTTP admin
    endpoint; with neither, the replicas' own checkpoint polls pick the new
    file up on their next interval."""
    if rolling_reload is not None:
        return {"mode": "inproc", "results": rolling_reload()}
    if gateway_url:
        req = urllib.request.Request(
            f"{str(gateway_url).rstrip('/')}/admin/rolling_reload", data=b"{}", method="POST"
        )
        with urllib.request.urlopen(req, timeout=120.0) as resp:
            return {"mode": "http", "results": json.loads(resp.read()).get("results")}
    return {"mode": "poll", "results": None}


def run_flywheel(
    run_dir: Any,
    ckpt_path: Any,
    cfg: Any = None,
    rolling_reload: Optional[Callable] = None,
    emit: Any = None,
    core: Any = None,
) -> Dict[str, Any]:
    """One full flywheel turn; returns the combined summary (ingest stats,
    finetune metrics, the new checkpoint path and the reload outcome).

    ``run_dir`` is the serving run's directory (capture segments under
    ``<run_dir>/capture`` by default, ``flywheel.capture_dir`` overrides);
    ``ckpt_path`` the currently-served checkpoint whose directory receives
    the fine-tuned successor. ``core`` (optional) is a built PolicyCore for
    the generic greedy-BC fallback when the algo has no registered finetune
    step. The flywheel's own telemetry lands in
    ``<run_dir>/flywheel/telemetry.jsonl`` (doctor merges it)."""
    from ..data.buffers import ReplayBuffer
    from ..telemetry.sinks import JsonlSink
    from ..utils.checkpoint import CheckpointManager

    run_dir = pathlib.Path(run_dir)
    ckpt_path = pathlib.Path(ckpt_path)
    capture_root = pathlib.Path(
        _sel(cfg, "flywheel.capture_dir", "") or (run_dir / "capture")
    )
    own_sink = None
    if emit is None:
        own_sink = JsonlSink(str(run_dir / "flywheel" / "telemetry.jsonl"))
        emit = own_sink.write
    t0 = time.monotonic()
    try:
        payload = CheckpointManager.load(ckpt_path)
        if not isinstance(payload, dict) or "params" not in payload:
            raise ValueError(f"checkpoint {ckpt_path} carries no 'params' tree")
        algo = str(
            _sel(cfg, "flywheel.algo", "") or payload.get("algo") or "synthetic_counter"
        )
        # resolve the finetune step FIRST: an unregistered algo must fail
        # before a single capture sample is consumed, not after
        step_fn = build_finetune_step(algo, cfg, core=core)
        rb = ReplayBuffer(
            buffer_size=int(_sel(cfg, "flywheel.buffer_size", 100_000)),
            n_envs=1,
            seed=int(_sel(cfg, "flywheel.seed", 0)),
        )
        ledger = IngestLedger(capture_root / "ingest_ledger.json")
        # the durable ledger write is DEFERRED until the fine-tuned
        # checkpoint has landed: a crash mid-burst re-ingests this batch on
        # the next turn instead of silently losing it to training forever
        summary: Dict[str, Any] = {
            "ingest": ingest(
                capture_root,
                rb,
                ledger=ledger,
                max_version_lag=int(_sel(cfg, "flywheel.max_version_lag", 4)),
                serving_version=_resolve_serving_version(cfg),
                emit=emit,
                save_ledger=False,
            )
        }
        if summary["ingest"]["samples"] <= 0:
            # stale-dropped records were still consumed — persist that
            ledger.save()
            summary["skipped"] = "no fresh capture samples to train on"
            return summary

        steps = int(_sel(cfg, "flywheel.steps", 10))
        batch_size = min(
            int(_sel(cfg, "flywheel.batch_size", 64)), summary["ingest"]["samples"]
        )
        params = payload["params"]
        metrics: Dict[str, Any] = {}
        for i in range(steps):
            raw = rb.sample(batch_size)
            batch = {k: np.asarray(v)[0] for k, v in raw.items()}  # [B, ...]
            params, metrics = step_fn(params, batch, None)
        new_step = _loaded_step(ckpt_path) + steps
        new_payload = dict(payload)
        new_payload["params"] = params
        new_path = write_checkpoint(ckpt_path.parent, new_step, new_payload)
        # the batch trained AND checkpointed: NOW its consumption is durable
        ledger.save()
        summary["finetune"] = {"steps": steps, "batch_size": batch_size, **metrics}
        summary["checkpoint"] = new_path
        _emit(
            emit,
            {
                "event": "flywheel",
                "action": "finetune",
                "steps": steps,
                "samples": summary["ingest"]["samples"],
                "step": new_step,
                "loss": float(metrics.get("loss") or 0.0),
            },
        )
        reload_out = _trigger_reload(_sel(cfg, "flywheel.gateway_url", None), rolling_reload)
        summary["reload"] = reload_out
        _emit(
            emit,
            {
                "event": "flywheel",
                "action": "reload",
                "step": new_step,
                "detail": str(reload_out.get("mode")),
            },
        )
        summary["duration_s"] = round(time.monotonic() - t0, 3)
        return summary
    finally:
        if own_sink is not None:
            own_sink.close()
