"""Map the JAX package's parameter and optimizer-state trees (nested dicts of
numpy arrays) onto the port's state dicts.

The port's modules carry the flax tree's names (see models/models.py), so a
flax path becomes a state-dict key by a rewrite:

* ``.../LayerNorm_k/LayerNorm_0/scale`` → ``....LayerNorm_k.weight`` (the JAX
  package wraps flax's ``nn.LayerNorm`` in its own ``LayerNorm``), ``bias``
  stays ``bias``;
* a Dense ``kernel`` [in, out] → ``weight`` [out, in] (this covers the fused
  GRU kernel [F+H, 3H] → [3H, F+H]);
* a Conv ``kernel`` HWIO → ``weight`` OIHW;
* a ConvTranspose ``kernel`` built with ``transpose_kernel=True``, laid out
  (kh, kw, out, in) as the HWIO kernel of the convolution it transposes, →
  ``weight`` [in, out, kh, kw]: an axis swap and no spatial flip
  (tests/test_torch_convert.py pins this against flax);
* a ConvTranspose ``kernel`` with ``transpose_kernel=False`` (SAC-AE's
  decoder; the module carries ``flax_transpose_kernel = False``), laid out
  (kh, kw, in, out) and applied unflipped to the dilated input, →
  ``weight`` [in, out, kh, kw] flipped in space
  (tests/test_torch_sac_ae.py pins this against flax);
* a Dense kernel under ``nn.vmap`` ([n, in, out], an ``EnsembleLinear``)
  keeps its layout;
* ``initial_recurrent_state`` keeps its name;
* a flax ``OptimizedLSTMCell`` (input kernels ``ii, if, ig, io`` without
  bias, hidden kernels ``hi, hf, hg, ho`` with bias) → an ``nn.LSTMCell``:
  ``weight_ih`` [4H, in] and ``weight_hh`` [4H, H] stack the transposed
  kernels in the order i, f, g, o, ``bias_hh`` the hidden biases, and
  ``bias_ih`` is zero (the port keeps it frozen);
* a flax ``GRUCell`` (``ir, iz, in`` with bias, ``hr, hz`` without, ``hn``
  with) → the port's ``models.GRUCell``: ``weight_i`` [3H, in] and
  ``weight_h`` [3H, H] stack the transposed kernels in the order r, z, n,
  ``bias_i`` the input biases, ``bias_hn`` stays.

The module type at each path decides the kernel layout. ``load_dreamer_v3``
loads ``{wm, actor, critic, target_critic}`` and, optionally, the optax adam
states (``mu``/``nu``/``count``) and the target-EMA step counter;
``load_ppo``, ``load_a2c`` and ``load_ppo_recurrent`` load the on-policy
agents and their Adam or RMSprop (``nu``) states; ``load_sac``,
``load_droq`` and ``load_sac_ae`` the off-policy agents (``log_alpha``
included) with the Adam states of each of their optimizers and the
gradient-step counter; ``load_dreamer_v2`` and ``load_dreamer_v1`` the
DreamerV2 and V1 agents with the states of their optimizers (Adam, AdamW,
``rmsprop`` or ``rmsprop_tf``, as each optimizer is) and DreamerV2's step
counter, the one that paces its target-critic copy. ``load_p2e_dv3``,
``load_p2e_dv2`` and ``load_p2e_dv1`` load the Plan2Explore agents (the
ensembles' stacked ``[n, in, out]`` kernels into ``EnsembleLinear``'s
weights of the same layout, P2E-DV3's dict of exploration critics with
their targets) with the states of every optimizer (one per exploration
critic) and the step counter; ``load_multi`` a ``MultiEncoder`` or
``MultiDecoder`` of those parts; ``load_moments`` turns the JAX package's
Moments (a ``MomentsState`` or a tree of them) into the port's.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def torch_key(path: str) -> str:
    """The state-dict key of a flax parameter path (before the leaf rename)."""
    parts = []
    for p in path.split("/"):
        if p == "LayerNorm_0" and parts and parts[-1].startswith("LayerNorm_"):
            continue
        parts.append(p)
    return ".".join(parts)


def kernel_to_torch(kernel: np.ndarray, module: nn.Module) -> np.ndarray:
    from .models import EnsembleLinear

    if isinstance(module, nn.Linear):
        return kernel.T
    if isinstance(module, EnsembleLinear):
        return kernel
    if isinstance(module, nn.ConvTranspose2d):
        if not getattr(module, "flax_transpose_kernel", True):
            return kernel[::-1, ::-1].transpose(2, 3, 0, 1)
        return kernel.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Conv2d):
        return kernel.transpose(3, 2, 0, 1)
    raise TypeError(f"no kernel layout for {type(module).__name__}")


_LSTM_GATES = ("i", "f", "g", "o")


def fold_lstm(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every flax ``OptimizedLSTMCell`` of a flattened tree as ``nn.LSTMCell``
    entries (``weight_ih``, ``weight_hh``, ``bias_ih`` = 0, ``bias_hh``)."""
    out: Dict[str, np.ndarray] = {}
    folded = set()
    for pre in sorted({p[: -len("/ii/kernel")] for p in flat if p.endswith("/ii/kernel")}):
        names = [f"{pre}/i{g}/kernel" for g in _LSTM_GATES] + [f"{pre}/h{g}/{leaf}" for g in _LSTM_GATES
                                                               for leaf in ("kernel", "bias")]
        out[f"{pre}/weight_ih"] = np.concatenate([flat[f"{pre}/i{g}/kernel"].T for g in _LSTM_GATES], 0)
        out[f"{pre}/weight_hh"] = np.concatenate([flat[f"{pre}/h{g}/kernel"].T for g in _LSTM_GATES], 0)
        out[f"{pre}/bias_hh"] = np.concatenate([flat[f"{pre}/h{g}/bias"] for g in _LSTM_GATES], 0)
        out[f"{pre}/bias_ih"] = np.zeros_like(out[f"{pre}/bias_hh"])
        folded.update(names)
    out.update({k: v for k, v in flat.items() if k not in folded})
    return out


_GRU_GATES = ("r", "z", "n")


def fold_gru(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every flax ``GRUCell`` of a flattened tree as ``models.GRUCell``
    entries (``weight_i``, ``bias_i``, ``weight_h``, ``bias_hn``)."""
    out: Dict[str, np.ndarray] = {}
    folded = set()
    for pre in sorted({p[: -len("ir/kernel")] for p in flat if p == "ir/kernel" or p.endswith("/ir/kernel")}):
        names = [f"{pre}i{g}/{leaf}" for g in _GRU_GATES for leaf in ("kernel", "bias")]
        names += [f"{pre}h{g}/kernel" for g in _GRU_GATES] + [f"{pre}hn/bias"]
        out[f"{pre}weight_i"] = np.concatenate([flat[f"{pre}i{g}/kernel"].T for g in _GRU_GATES], 0)
        out[f"{pre}bias_i"] = np.concatenate([flat[f"{pre}i{g}/bias"] for g in _GRU_GATES], 0)
        out[f"{pre}weight_h"] = np.concatenate([flat[f"{pre}h{g}/kernel"].T for g in _GRU_GATES], 0)
        out[f"{pre}bias_hn"] = flat[f"{pre}hn/bias"]
        folded.update(names)
    out.update({k: v for k, v in flat.items() if k not in folded})
    return out


def params_to_state_dict(params: Mapping[str, Any], module: nn.Module) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (or any tree of the same structure, e.g. adam's
    ``mu``) as a state dict of ``module``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in fold_gru(fold_lstm(flatten(params))).items():
        key = torch_key(path)
        mod_path, _, leaf = key.rpartition(".")
        if leaf == "kernel":
            leaf = "weight"
            arr = kernel_to_torch(arr, module.get_submodule(mod_path))
        elif leaf == "scale":
            leaf = "weight"
        name = f"{mod_path}.{leaf}" if mod_path else leaf
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return sd


def load_params(params: Mapping[str, Any], module: nn.Module) -> None:
    """Load a flax parameter tree into ``module`` (strict: every parameter
    of both sides must match)."""
    module.load_state_dict(params_to_state_dict(params, module), strict=True)


def load_multi(params: Mapping[str, Any], module: nn.Module) -> None:
    """Load a flax ``MultiEncoder`` or ``MultiDecoder`` tree
    (``cnn_encoder``/``mlp_encoder``, ``cnn_decoder``/``mlp_decoder``) into
    the port's module of the same parts: dense kernels ``[in,out]`` →
    ``[out,in]``, conv kernels HWIO → OIHW, by path."""
    load_params(params, module)


def find_state(opt_state: Any, fields=("mu", "nu", "count")) -> Any:
    """The optax state inside a chain state that has all of ``fields``
    (``ScaleByAdamState`` by default)."""
    if all(hasattr(opt_state, a) for a in fields):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = find_state(s, fields)
            if found is not None:
                return found
    return None


def load_adam_state(optimizer: torch.optim.Optimizer, module: nn.Module, opt_state: Any) -> None:
    """optax adam moments → ``torch.optim.Adam`` state of ``module``'s
    parameters (the optimizer must own exactly those parameters)."""
    adam = find_state(opt_state)
    if adam is None:
        raise ValueError("no adam state (mu, nu, count) in the optax state")
    mu = params_to_state_dict(adam.mu, module)
    nu = params_to_state_dict(adam.nu, module)
    step = float(np.asarray(adam.count))
    for name, p in module.named_parameters():
        if not p.requires_grad:  # a frozen parameter (an LSTM's bias_ih) has no optimizer state
            continue
        optimizer.state[p] = {
            "step": torch.tensor(step),
            "exp_avg": mu[name].to(p.device).clone(),
            "exp_avg_sq": nu[name].to(p.device).clone(),
        }


def load_dreamer_v3(
    params: Mapping[str, Any],
    wm: nn.Module,
    actor: nn.Module,
    critic: nn.Module,
    target_critic: nn.Module,
    opt_states: Optional[Mapping[str, Any]] = None,
    optimizers: Any = None,
) -> None:
    """Load the JAX DreamerV3 ``params`` (and, with ``optimizers``, its
    ``opt_states``) into the port's modules and ``DV3Optimizers``."""
    for key, module in (("wm", wm), ("actor", actor), ("critic", critic), ("target_critic", target_critic)):
        load_params(params[key], module)
    if opt_states is not None and optimizers is not None:
        load_adam_state(optimizers.wm.optimizer, wm, opt_states["wm"])
        load_adam_state(optimizers.actor.optimizer, actor, opt_states["actor"])
        load_adam_state(optimizers.critic.optimizer, critic, opt_states["critic"])
        optimizers.step = int(np.asarray(opt_states["step"]))


def load_rmsprop_state(optimizer: torch.optim.Optimizer, module: nn.Module, opt_state: Any) -> None:
    """optax rmsprop's ``ν`` → the port's ``RMSprop`` state of ``module``'s
    parameters (optax keeps no step count there; ``step`` starts at 0)."""
    rms = find_state(opt_state, ("nu",))
    if rms is None:
        raise ValueError("no rmsprop state (nu) in the optax state")
    nu = params_to_state_dict(rms.nu, module)
    for name, p in module.named_parameters():
        optimizer.state[p] = {"step": torch.zeros((), dtype=torch.float32), "nu": nu[name].to(p.device).clone()}


def load_ppo(params: Mapping[str, Any], agent: nn.Module, opt_state: Any = None, optimizer: Any = None) -> None:
    """The JAX PPO agent's ``params`` (and, with ``optimizer``, the Adam
    state of ``opt_state``) into the port's ``PPOAgent`` and optimizer (a
    ``Clipped`` or a torch optimizer)."""
    load_params(params, agent)
    if opt_state is not None and optimizer is not None:
        load_adam_state(getattr(optimizer, "optimizer", optimizer), agent, opt_state)


def load_a2c(params: Mapping[str, Any], agent: nn.Module, opt_state: Any = None, optimizer: Any = None) -> None:
    """The JAX A2C agent's ``params`` (and its RMSprop ``ν``) into the port's."""
    load_params(params, agent)
    if opt_state is not None and optimizer is not None:
        load_rmsprop_state(getattr(optimizer, "optimizer", optimizer), agent, opt_state)


def load_ppo_recurrent(params: Mapping[str, Any], agent: nn.Module, opt_state: Any = None,
                       optimizer: Any = None) -> None:
    """The JAX recurrent PPO agent's ``params`` (the LSTM folded into
    ``nn.LSTMCell`` form) and its Adam state into the port's."""
    load_ppo(params, agent, opt_state, optimizer)


def load_scalar_adam_state(optimizer: torch.optim.Optimizer, param: torch.Tensor, opt_state: Any) -> None:
    """optax adam's state of one array leaf (``log_alpha``) → the
    ``torch.optim.Adam`` state of ``param``."""
    adam = find_state(opt_state)
    if adam is None:
        raise ValueError("no adam state (mu, nu, count) in the optax state")
    optimizer.state[param] = {
        "step": torch.tensor(float(np.asarray(adam.count))),
        "exp_avg": torch.as_tensor(np.array(adam.mu, np.float32)).to(param.device),
        "exp_avg_sq": torch.as_tensor(np.array(adam.nu, np.float32)).to(param.device),
    }


def _load_log_alpha(params: Mapping[str, Any], agent: nn.Module) -> None:
    with torch.no_grad():
        agent.log_alpha.copy_(torch.as_tensor(np.array(params["log_alpha"], np.float32)))


def load_sac(params: Mapping[str, Any], agent: nn.Module, opt_states: Optional[Mapping[str, Any]] = None,
             optimizers: Any = None) -> None:
    """The JAX SAC (or DroQ) ``params`` ``{actor, critic, target_critic,
    log_alpha}`` into the port's ``SACAgent`` (the critics' leading ``n``
    axis kept) and, with ``optimizers`` (``sac.Optimizers``), the Adam
    states of ``opt_states`` and its target-EMA ``step`` (DroQ's has none:
    its EMA runs every step)."""
    for key in ("actor", "critic", "target_critic"):
        load_params(params[key], getattr(agent, key))
    _load_log_alpha(params, agent)
    if opt_states is not None and optimizers is not None:
        load_adam_state(optimizers["actor"], agent.actor, opt_states["actor"])
        load_adam_state(optimizers["critic"], agent.critic, opt_states["critic"])
        load_scalar_adam_state(optimizers["alpha"], agent.log_alpha, opt_states["alpha"])
        optimizers.step = int(np.asarray(opt_states.get("step", 0)))


def load_droq(params: Mapping[str, Any], agent: nn.Module, opt_states: Optional[Mapping[str, Any]] = None,
              optimizers: Any = None) -> None:
    """DroQ's tree is SAC's (its critic has LayerNorms between the layers)."""
    load_sac(params, agent, opt_states, optimizers)


def load_sac_ae(params: Mapping[str, Any], agent: nn.Module, opt_states: Optional[Mapping[str, Any]] = None,
                optimizers: Any = None) -> None:
    """The JAX SAC-AE ``params`` ``{encoder, qs, actor, decoder, log_alpha,
    target_encoder, target_qs}`` into the port's ``SACAEAgent`` and, with
    ``optimizers``, the Adam states of ``qf`` (over ``{encoder, qs}``),
    ``actor``, ``alpha``, ``encoder`` and ``decoder`` (AdamW) and ``step``."""
    for key in ("encoder", "qs", "actor", "decoder", "target_encoder", "target_qs"):
        load_params(params[key], getattr(agent, key))
    _load_log_alpha(params, agent)
    if opt_states is not None and optimizers is not None:
        qf = nn.ModuleDict({"encoder": agent.encoder, "qs": agent.qs})
        load_adam_state(optimizers["qf"], qf, opt_states["qf"])
        load_adam_state(optimizers["actor"], agent.actor, opt_states["actor"])
        load_scalar_adam_state(optimizers["alpha"], agent.log_alpha, opt_states["alpha"])
        load_adam_state(optimizers["encoder"], agent.encoder, opt_states["encoder"])
        load_adam_state(optimizers["decoder"], agent.decoder, opt_states["decoder"])
        optimizers.step = int(np.asarray(opt_states["step"]))


def load_rmsprop_tf_state(optimizer: torch.optim.Optimizer, module: nn.Module, opt_state: Any) -> None:
    """The JAX package's ``RMSpropTFState`` (``square_avg``,
    ``momentum_buf``, ``grad_avg``) → the port's ``RMSpropTF`` state of
    ``module``'s parameters (no step count there; ``step`` starts at 0)."""
    rms = find_state(opt_state, ("square_avg", "momentum_buf", "grad_avg"))
    if rms is None:
        raise ValueError("no rmsprop_tf state (square_avg, momentum_buf, grad_avg) in the optax state")
    trees = {"square_avg": rms.square_avg, "momentum_buffer": rms.momentum_buf, "grad_avg": rms.grad_avg}
    sds = {k: params_to_state_dict(v, module) for k, v in trees.items() if v is not None}
    for name, p in module.named_parameters():
        optimizer.state[p] = {"step": torch.zeros((), dtype=torch.float32),
                              **{k: sd[name].to(p.device).clone() for k, sd in sds.items()}}


def load_optimizer_state(optimizer: Any, module: nn.Module, opt_state: Any) -> None:
    """The optax state of ``module``'s optimizer into the port's
    ``optimizer`` (a ``Clipped`` or a torch optimizer): Adam and AdamW take
    the adam moments, ``RMSprop`` optax rmsprop's ``ν``, ``RMSpropTF`` the
    ``RMSpropTFState``."""
    from .optim import RMSprop, RMSpropTF

    optimizer = getattr(optimizer, "optimizer", optimizer)
    if isinstance(optimizer, RMSpropTF):
        load_rmsprop_tf_state(optimizer, module, opt_state)
    elif isinstance(optimizer, RMSprop):
        load_rmsprop_state(optimizer, module, opt_state)
    else:
        load_adam_state(optimizer, module, opt_state)


def load_dreamer_v2(params: Mapping[str, Any], wm: nn.Module, actor: nn.Module, critic: nn.Module,
                    target_critic: nn.Module, opt_states: Optional[Mapping[str, Any]] = None,
                    optimizers: Any = None) -> None:
    """The JAX DreamerV2 ``params`` ``{wm, actor, critic, target_critic}``
    and, with ``optimizers`` (``DV3Optimizers``), the states of
    ``opt_states`` and its ``step`` (the target-copy counter)."""
    for key, module in (("wm", wm), ("actor", actor), ("critic", critic), ("target_critic", target_critic)):
        load_params(params[key], module)
    if opt_states is not None and optimizers is not None:
        for key, module in (("wm", wm), ("actor", actor), ("critic", critic)):
            load_optimizer_state(getattr(optimizers, key), module, opt_states[key])
        optimizers.step = int(np.asarray(opt_states["step"]))


def load_dreamer_v1(params: Mapping[str, Any], wm: nn.Module, actor: nn.Module, critic: nn.Module,
                    opt_states: Optional[Mapping[str, Any]] = None, optimizers: Any = None) -> None:
    """The JAX DreamerV1 ``params`` ``{wm, actor, critic}`` (the GRU folded
    into ``models.GRUCell`` form) and, with ``optimizers``, the states of
    ``opt_states``; DreamerV1's JAX state has no step counter, so
    ``optimizers.step`` takes the world model's Adam count where there is
    one."""
    for key, module in (("wm", wm), ("actor", actor), ("critic", critic)):
        load_params(params[key], module)
    if opt_states is not None and optimizers is not None:
        for key, module in (("wm", wm), ("actor", actor), ("critic", critic)):
            load_optimizer_state(getattr(optimizers, key), module, opt_states[key])
        adam = find_state(opt_states["wm"])
        optimizers.step = int(np.asarray(adam.count)) if adam is not None else 0


def load_moments(moments: Any) -> Any:
    """The JAX package's ``MomentsState(low, high)`` (or a dict tree of them,
    as P2E-DV3's ``{task, exploration: {name: ...}}``) as the port's."""
    from .algos.dreamer_v3.utils import MomentsState

    if isinstance(moments, Mapping):
        return {k: load_moments(v) for k, v in moments.items()}
    return MomentsState(torch.as_tensor(np.array(moments[0], np.float32)),
                        torch.as_tensor(np.array(moments[1], np.float32)))


def load_p2e(params: Mapping[str, Any], mods: Mapping[str, nn.Module], opt_states: Optional[Mapping[str, Any]] = None,
             optimizers: Any = None) -> None:
    """A JAX Plan2Explore agent's ``params`` into the port's modules (the
    dict of the variant's ``build_agent``, whose keys are the JAX tree's:
    P2E-DV3's ``critics_exploration: {name: {critic, target}}``, P2E-DV2's
    task and exploration target critics, P2E-DV1's GRU folded into
    ``models.GRUCell`` form) and, with ``optimizers`` (a ``P2EOptimizers``),
    each optimizer's state from ``opt_states`` (P2E-DV3's dict of
    exploration-critic optimizers takes the states of its critics) and the
    ``step`` counter (P2E-DV1's JAX state has none: 0)."""
    for name, module in mods.items():
        load_params(params[name], module)
    if opt_states is None or optimizers is None:
        return
    for name in optimizers.names:
        opt = getattr(optimizers, name)
        if isinstance(opt, dict):
            for k, o in opt.items():
                load_optimizer_state(o, mods[name][k]["critic"], opt_states[name][k])
        else:
            load_optimizer_state(opt, mods[name], opt_states[name])
    optimizers.step = int(np.asarray(opt_states.get("step", 0)))


load_p2e_dv3 = load_p2e_dv2 = load_p2e_dv1 = load_p2e
