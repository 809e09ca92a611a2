"""`InferencePolicy` — one checkpoint→policy adapter for every algorithm (the
port's counterpart of ``sheeprl_tpu/serve/policy.py``).

A registered *policy builder* wraps an algorithm's modules behind one batched
``apply`` with the canonical signature

    apply(params, obs, state, noise, greedy) -> (actions, new_state)

``params`` is a dict of module name → ``{parameter name: tensor}`` on the
policy's device, run through the builder's modules with
``torch.func.functional_call``; ``state`` is ``None`` for feed-forward
policies, recurrent ones (DreamerV3) carry their latents through it;
``noise`` holds the batch's pre-drawn samples (``draw_noise(generator,
bucket)``, from the policy's own ``torch.Generator``), so a builder never
draws inside ``apply``. `InferencePolicy` owns:

* **buckets** — requests are zero-padded up to the smallest power-of-two
  bucket that fits, so only those shapes ever run. The apply is eager:
  ``warmup()`` runs every (bucket, greedy) pair once on the device, which
  warms the caching allocator and lets cuBLAS and cuDNN choose their
  algorithms; ``retraces_since_warmup()`` counts act calls at a pair warmup
  did not run (0 with padding, as the JAX package's retrace count is).
* **double-buffered params** — ``swap_params(state)`` builds a NEW dict of
  device tensors, waits for its copy to finish, and only then swaps the one
  reference under a lock. Nothing is copied into tensors a batch may still
  read: a batch that took the old dict keeps computing with it.
* **per-session recurrent state** — a `SessionStore` maps session ids to
  host-side numpy rows; ``act_batch`` gathers a batch's rows, steps them
  together, and scatters the updated rows back.

Builders are registered per algorithm name in `serve.builders`; evaluation
(`serve.evaluate`) and the serving stack (`serve.batcher`, `serve.server`)
both go through this class, so there is one checkpoint→policy path.
"""
from __future__ import annotations

import contextlib
import pathlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

# algo name -> builder(cfg, observation_space, action_space) -> PolicyCore
POLICY_BUILDERS: Dict[str, Callable] = {}


def register_policy_builder(*names: str) -> Callable:
    """Register a policy builder for one or more algorithm names."""

    def wrap(fn: Callable) -> Callable:
        for name in names:
            if name in POLICY_BUILDERS:
                raise ValueError(f"Policy builder for '{name}' already registered")
            POLICY_BUILDERS[name] = fn
        return fn

    return wrap


def get_policy_builder(name: str) -> Callable:
    from . import builders  # noqa: F401  (populates POLICY_BUILDERS on import)

    if name not in POLICY_BUILDERS:
        raise ValueError(f"No policy builder registered for '{name}'. Available: {sorted(POLICY_BUILDERS)}")
    return POLICY_BUILDERS[name]


@dataclass
class PolicyCore:
    """What a builder hands back: one algorithm's policy on ``device``.

    ``extract_params`` maps a checkpoint's state to the (smaller) inference
    subtree, a dict of module name → state dict: the optimizer, critic and
    target entries never reach the serving device. ``draw_noise(generator,
    n)`` draws one batch's noise for ``apply``; ``tol`` is the tolerance a
    row served in a mixed bucket keeps against the same row served alone
    (kernels picked per row count sum in another order)."""

    apply: Callable  # (params, obs, state, noise, greedy) -> (actions, state)
    extract_params: Callable[[Any], Dict[str, Dict[str, Any]]]
    prepare: Callable[[Dict[str, np.ndarray], int], Any]  # raw env obs -> batched numpy tree
    dummy_obs: Callable[[int], Any]  # batch size -> zeros obs tree (for warmup)
    draw_noise: Callable[[torch.Generator, int], Any]
    device: torch.device
    init_state: Optional[Callable] = None  # (params, n) -> state tuple; None = stateless
    name: str = "policy"
    tol: float = 1e-5

    @property
    def stateful(self) -> bool:
        return self.init_state is not None


class SessionExpired(KeyError):
    """The session's recurrent state was LRU-evicted while the session was
    still live. Re-initializing the latent silently would corrupt the
    session's trajectory — the server answers HTTP 410 instead, and the
    caller re-hydrates it."""

    def __init__(self, sid: str) -> None:
        super().__init__(f"session '{sid}' expired: its state was evicted (LRU bound)")
        self.session_id = str(sid)


class SessionStore:
    """Host-side per-session recurrent state rows (each a tuple of [1, ...]
    numpy arrays).

    Bounded: beyond ``max_sessions`` ids the least-recently-used row is
    evicted. Evicted ids leave a (bounded) TOMBSTONE, so a later request for
    one is told apart from a brand-new session: the act path raises
    :class:`SessionExpired` (HTTP 410) instead of silently restarting the
    latent. Re-hydrating the session (``put``) clears its tombstone.
    ``on_evict(sid)`` fires per eviction so the serving stats can count
    them."""

    def __init__(self, max_sessions: int = 4096, max_tombstones: Optional[int] = None) -> None:
        self.max_sessions = int(max_sessions)
        self.max_tombstones = int(max_tombstones if max_tombstones is not None else 4 * self.max_sessions)
        self.on_evict: Optional[Any] = None  # callback(sid), set by the serving layer
        self._rows: "OrderedDict[str, Any]" = OrderedDict()
        self._tombstones: "OrderedDict[str, bool]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, sid: str) -> Optional[Any]:
        with self._lock:
            row = self._rows.get(sid)
            if row is not None:
                self._rows.move_to_end(sid)
            return row

    def put(self, sid: str, row: Any) -> None:
        evicted: List[str] = []
        with self._lock:
            self._rows[sid] = row
            self._rows.move_to_end(sid)
            self._tombstones.pop(sid, None)  # (re)hydrated: no longer expired
            while len(self._rows) > self.max_sessions:
                old_sid, _ = self._rows.popitem(last=False)
                self._tombstones[old_sid] = True
                self._tombstones.move_to_end(old_sid)
                evicted.append(old_sid)
            while len(self._tombstones) > self.max_tombstones:
                self._tombstones.popitem(last=False)
        # callbacks run outside the lock: an emitting sink must not block puts
        cb = self.on_evict
        if cb is not None:
            for old_sid in evicted:
                try:
                    cb(old_sid)
                except Exception:
                    pass

    def expired(self, sid: str) -> bool:
        """True when this id's state was evicted and never re-hydrated."""
        with self._lock:
            return sid in self._tombstones

    def drop(self, sid: str) -> None:
        with self._lock:
            self._rows.pop(sid, None)
            self._tombstones.pop(sid, None)

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()
            self._tombstones.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)


def env_action(row: np.ndarray, action_space: Any) -> Any:
    """Convert one action row of a batch to what ``env.step`` expects."""
    from ..envs import spaces

    row = np.asarray(row)
    if isinstance(action_space, spaces.Box):
        return row.reshape(action_space.shape)
    if isinstance(action_space, spaces.MultiDiscrete):
        return row.reshape(-1)
    return row.reshape(-1)[0].item()


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of matching dict / tuple / list trees (the
    obs, state and noise trees the policies take)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    if first is None:
        return None
    return fn(*trees)


def tree_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a dict / tuple / list tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_leaves(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (tuple, list)):
        return [pl for i, x in enumerate(tree) for pl in tree_leaves(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _tree_structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return ("dict", tuple((k, _tree_structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_tree_structure(x) for x in tree))
    return "leaf"


def stack_rows(rows: List[Any]) -> Any:
    """Concatenate [1, ...] row trees along the batch axis."""
    return tree_map(lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=0), *rows)


def pad_rows(tree: Any, n: int, bucket: int) -> Any:
    """Zero-pad every leaf of a numpy tree from ``n`` to ``bucket`` rows."""
    if bucket == n:
        return tree

    def pad_leaf(x: Any) -> np.ndarray:
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((bucket - n,) + x.shape[1:], x.dtype)], axis=0)

    return tree_map(pad_leaf, tree)


def to_host(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def to_device(tree: Any, device: torch.device) -> Any:
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(device), tree)


def device_params(params: Dict[str, Dict[str, Any]], device: torch.device) -> Dict[str, Dict[str, torch.Tensor]]:
    """A NEW dict of ``device`` tensors holding ``params`` (module name →
    state dict of tensors or numpy arrays), its copies finished before it
    returns: a dict a batch may read is never written into."""
    out = {name: {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                  .to(device, copy=True).contiguous() for k, v in sd.items()}
           for name, sd in params.items()}
    if device.type == "cuda":
        # reloads are rare: wait for this thread's copies on the host
        torch.cuda.current_stream(device).synchronize()
    return out


def serve_device(cfg: Any) -> torch.device:
    """Where a policy serves: the player's device of the run (the card by
    default; the host with ``algo.player.device=host`` or
    ``fabric.accelerator=cpu``). Nothing falls back."""
    from ..parallel.placement import player_device
    from ..utils.utils import get_device

    return player_device(cfg, get_device(cfg, single=True))


class InferencePolicy:
    """A trained checkpoint behind one batched ``act`` API."""

    def __init__(
        self,
        core: PolicyCore,
        state_params: Any,
        cfg: Any = None,
        buckets: Optional[Sequence[int]] = None,
    ) -> None:
        self.core = core
        self.cfg = cfg
        raw = list(buckets if buckets is not None else (cfg.select("serve.buckets") if cfg is not None else None)
                   or DEFAULT_BUCKETS)
        self.buckets: List[int] = sorted({int(b) for b in raw})
        if any(b <= 0 for b in self.buckets):
            raise ValueError(f"serve.buckets must be positive, got {self.buckets}")
        self.device = torch.device(core.device)
        self._params_lock = threading.Lock()
        self._act_lock = threading.Lock()
        self._params = device_params(core.extract_params(state_params), self.device)
        # serve.seed may exist as an explicit null — fall back to the run's
        # seed in that case too, not only when the key is absent
        serve_seed = cfg.select("serve.seed") if cfg is not None else None
        if serve_seed is None:
            serve_seed = (cfg.select("seed", 0) if cfg is not None else 0) or 0
        self.generator = torch.Generator(device=self.device).manual_seed(int(serve_seed))
        self.sessions = SessionStore(int(cfg.select("serve.max_sessions", 4096) or 4096) if cfg is not None else 4096)
        self.reload_count = 0
        self.params_version = 0
        # monotonic stamp of the last param (re)load: /healthz reports the age
        self.params_refreshed_at = time.monotonic()
        self._init_row: Optional[Any] = None
        # the acting thread's own CUDA stream: a serving batch never queues
        # behind another thread's work on the default stream
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._warm: Set[Tuple[int, bool]] = set()
        self._misses = 0
        # canonical per-leaf obs spec (from the builder's dummy obs): what a
        # prepared request must look like, checked before it can join a batch
        template = core.dummy_obs(1)
        self._obs_structure = _tree_structure(template)
        self._obs_spec = [(p, tuple(np.asarray(l).shape[1:]), np.asarray(l).dtype) for p, l in tree_leaves(template)]
        if core.stateful:
            self._refresh_init_row()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_state(
        cls,
        cfg: Any,
        state_params: Any,
        observation_space: Any,
        action_space: Any,
        buckets: Optional[Sequence[int]] = None,
    ) -> "InferencePolicy":
        algo = str(cfg.select("algo.name"))
        core = get_policy_builder(algo)(cfg, observation_space, action_space)
        return cls(core, state_params, cfg=cfg, buckets=buckets)

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_path: Any,
        cfg: Any = None,
        buckets: Optional[Sequence[int]] = None,
    ) -> "InferencePolicy":
        """Build from a checkpoint file; the run's saved ``config.yaml`` is
        loaded from beside it when ``cfg`` is not given. The load skips
        optimizer state and replay buffers (`load_for_inference`)."""
        from ..config import load_config_file
        from ..utils.checkpoint import CheckpointManager
        from ..utils.env import probe_env_spaces

        ckpt_path = pathlib.Path(ckpt_path)
        if cfg is None:
            cfg_path = ckpt_path.parent.parent / "config.yaml"
            if not cfg_path.is_file():
                raise FileNotFoundError(f"Missing saved config beside checkpoint: {cfg_path}")
            cfg = load_config_file(cfg_path)
        state = CheckpointManager.load_for_inference(ckpt_path)
        spaces = probe_env_spaces(cfg, int(cfg.select("seed", 0) or 0))
        return cls.from_state(cfg, state, spaces.single_observation_space, spaces.single_action_space, buckets=buckets)

    # -- hot reload --------------------------------------------------------
    def swap_params(self, state_params: Any) -> int:
        """Double-buffered weight swap: a new dict of device tensors, its
        copy finished, then one reference swapped. A batch in flight keeps
        the dict it took; the next batch takes the new one."""
        new = device_params(self.core.extract_params(state_params), self.device)
        with self._params_lock:
            self._params = new
            self.params_version += 1
            self.reload_count += 1
            self.params_refreshed_at = time.monotonic()
            version = self.params_version
        if self.core.stateful:
            self._refresh_init_row()
        return version

    def params_staleness_s(self) -> float:
        """Seconds since the served params were last loaded or swapped."""
        with self._params_lock:
            return max(0.0, time.monotonic() - self.params_refreshed_at)

    def current_params(self) -> Tuple[Any, int]:
        with self._params_lock:
            return self._params, self.params_version

    def _refresh_init_row(self) -> None:
        params, _ = self.current_params()
        with self._act_lock, self._on_stream():
            row = self.core.init_state(params, 1)  # type: ignore[misc]
            self._init_row = to_host(row)

    def _on_stream(self) -> contextlib.ExitStack:
        """Inference mode, on the policy's own CUDA stream where it has one."""
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.inference_mode())
        if self._stream is not None:
            ctx.enter_context(torch.cuda.stream(self._stream))
        return ctx

    # -- warmup / shape-miss accounting ------------------------------------
    def warmup(self, greedy_variants: Sequence[bool] = (True, False)) -> int:
        """Run the apply once for every (bucket, greedy) pair on the device;
        after this no batch up to the largest bucket runs a shape warmup did
        not. Returns the number of pairs run."""
        params, _ = self.current_params()
        runs = 0
        for b in self.buckets:
            obs = self.core.dummy_obs(b)
            state = stack_rows([self._init_row] * b) if self.core.stateful else None
            for greedy in greedy_variants:
                with self._act_lock:
                    self._apply(params, obs, state, b, bool(greedy))
                self._warm.add((b, bool(greedy)))
                runs += 1
        self._misses = 0
        return runs

    def retraces_since_warmup(self) -> int:
        """Act calls at a (bucket, greedy) pair warmup did not run."""
        return self._misses

    def _apply(self, params: Any, obs: Any, state: Any, bucket: int, greedy: bool) -> Tuple[np.ndarray, Any]:
        """One padded batch on the device; host numpy in, host numpy out.
        Caller holds ``_act_lock`` (the policy's generator and stream)."""
        with self._on_stream():
            obs_t = to_device(obs, self.device)
            state_t = to_device(state, self.device) if state is not None else None
            noise = self.core.draw_noise(self.generator, bucket)
            actions, new_state = self.core.apply(params, obs_t, state_t, noise, greedy)
            actions_np = actions.cpu().numpy()
            host_state = to_host(new_state) if new_state is not None else None
            if self._stream is not None:
                self._stream.synchronize()
        return actions_np, host_state

    def roofline_records(self) -> list:
        """One roofline verdict per bucket (greedy variant): the operations
        and bytes of the bucketed apply (``telemetry.throughput.model_cost``)
        against this device's roof. Serving is memory-bound at bucket 1 and
        climbs toward the ridge as occupancy grows. Best-effort: returns the
        records made before any failure."""
        from ..telemetry.throughput import model_cost, peak_record, roofline_record

        out: list = []
        try:
            cuda = self.device.type == "cuda"
            kind = torch.cuda.get_device_name(self.device) if cuda else "cpu"
            peaks = peak_record(kind) if cuda else {}
            params, _ = self.current_params()
            for b in self.buckets:
                obs = self.core.dummy_obs(b)
                state = stack_rows([self._init_row] * b) if self.core.stateful else None
                with self._act_lock:
                    _, cost = model_cost(lambda: self._apply(params, obs, state, b, True))
                rec = roofline_record(
                    f"{self.core.name}_apply_b{b}", cost,
                    peak_flops=peaks.get("peak_flops"), peak_bytes_per_s=peaks.get("peak_bytes_per_s"),
                    device_kind=kind, basis=str(peaks.get("peak_bytes_per_s_basis") or ""), role="replica",
                )
                if rec is not None:
                    out.append(rec)
        except Exception:
            return out
        return out

    # -- the act path ------------------------------------------------------
    def prepare(self, raw_obs: Dict[str, Any], n: int = 1) -> Any:
        return self.core.prepare(raw_obs, n)

    def validate_prepared(self, tree: Any, n: int) -> None:
        """Reject a prepared obs whose structure/shape/dtype deviates from
        the warmed template — BEFORE it can poison a coalesced batch or run
        an unwarmed shape. Raises ValueError with the offending leaf."""
        flat = tree_leaves(tree)
        if _tree_structure(tree) != self._obs_structure or len(flat) != len(self._obs_spec):
            expected = [p for p, _, _ in self._obs_spec]
            raise ValueError(f"obs structure mismatch: expected leaves {expected}")
        for (_, leaf), (spath, sshape, sdtype) in zip(flat, self._obs_spec):
            a = np.asarray(leaf)
            if a.shape != (n, *sshape):
                raise ValueError(f"obs leaf {spath or 'obs'} has shape {a.shape}, expected {(n, *sshape)}")
            if a.dtype != sdtype:
                raise ValueError(f"obs leaf {spath or 'obs'} has dtype {a.dtype}, expected {sdtype}")

    # -- session externalization -------------------------------------------
    def export_session(self, sid: str) -> Optional[Any]:
        """The session's current host-side state row (None when unknown or
        stateless)."""
        if not self.core.stateful:
            return None
        return self.sessions.get(sid)

    def import_session(self, sid: str, row: Any) -> None:
        """Install an externalized state row (re-hydrate or migration).
        Overwrites any cached row and clears the session's tombstone."""
        if not self.core.stateful:
            return
        self.sessions.put(sid, tuple(np.asarray(x) for x in row))

    def session_expired(self, sid: str) -> bool:
        return self.core.stateful and self.sessions.expired(sid)

    def act_batch(
        self,
        obs: Any,
        n: int,
        deterministic: bool = False,
        sessions: Optional[Sequence[Optional[str]]] = None,
        expired_out: Optional[List[int]] = None,
    ) -> np.ndarray:
        """Run one prepared obs batch (leading dim ``n``) through the policy.

        Pads to the enclosing bucket, steps, and slices back to ``n`` rows.
        Batches larger than the largest bucket are processed in max-bucket
        chunks. For stateful policies, per-session state rows are gathered
        before and scattered after the step (``sessions[i] is None`` rows act
        from a fresh initial state and are not persisted).

        ``expired_out`` (when given) collects the indices of sessions whose
        state was LRU-evicted after the caller's expiry check but before this
        gather: those rows ran on a throwaway initial state and are neither
        persisted nor safe to ack (the caller fails each with
        :class:`SessionExpired`).
        """
        max_bucket = self.buckets[-1]
        if n > max_bucket:
            outs = []
            for lo in range(0, n, max_bucket):
                hi = min(n, lo + max_bucket)
                chunk = tree_map(lambda x: np.asarray(x)[lo:hi], obs)
                sess = sessions[lo:hi] if sessions is not None else None
                sub_expired: Optional[List[int]] = [] if expired_out is not None else None
                outs.append(self.act_batch(chunk, hi - lo, deterministic, sess, sub_expired))
                if expired_out is not None and sub_expired:
                    expired_out.extend(lo + i for i in sub_expired)
            return np.concatenate(outs, axis=0)

        bucket = _bucket_for(n, self.buckets)
        params, _ = self.current_params()
        state = None
        sess_list: List[Optional[str]] = list(sessions) if sessions is not None else []
        expired_idx: set = set()
        if self.core.stateful:
            rows = []
            for i in range(n):
                sid = sess_list[i] if i < len(sess_list) else None
                row = self.sessions.get(sid) if sid is not None else None
                if row is None and sid is not None and expired_out is not None and self.sessions.expired(sid):
                    expired_idx.add(i)
                rows.append(row if row is not None else self._init_row)
            rows.extend([self._init_row] * (bucket - n))
            state = stack_rows(rows)
        padded = pad_rows(obs, n, bucket)
        with self._act_lock:
            if (bucket, bool(deterministic)) not in self._warm:
                self._misses += 1
                self._warm.add((bucket, bool(deterministic)))
            actions_np, host_state = self._apply(params, padded, state, bucket, bool(deterministic))
        actions_np = actions_np[:n]
        if self.core.stateful and host_state is not None:
            for i in range(n):
                sid = sess_list[i] if i < len(sess_list) else None
                if sid is not None and i not in expired_idx:
                    self.sessions.put(sid, tuple(x[i:i + 1] for x in host_state))
        if expired_out is not None:
            expired_out.extend(sorted(expired_idx))
        return actions_np

    def act(
        self,
        raw_obs: Dict[str, Any],
        deterministic: bool = False,
        session: Optional[str] = None,
    ) -> np.ndarray:
        """Single-request convenience path (evaluation, in-process clients):
        prepare → act_batch(1) → the [1, ...] action array."""
        prepared = self.prepare(raw_obs, 1)
        return self.act_batch(prepared, 1, deterministic=deterministic, sessions=[session])
