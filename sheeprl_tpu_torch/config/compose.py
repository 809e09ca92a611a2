"""Hydra-compatible YAML config composition (no Hydra dependency).

The port's own copy of ``sheeprl_tpu/config/compose.py``: it composes the
YAML tree under ``sheeprl_tpu_torch/configs/``.

The reference drives everything through Hydra 1.3 (reference
sheeprl/configs/config.yaml:4-15 — a `defaults:` list naming one option per
config group, plus `exp=???`). This module re-implements the subset of Hydra
semantics the framework needs:

* a config root directory with group subdirectories (``algo/``, ``env/``, ...)
* ``defaults:`` lists (``group: option``, ``override /group: option``,
  ``group@dest: option``, ``_self_``, ``optional group: option``)
* experiment files (``exp=dreamer_v3``) composed on top of the root
* CLI dotted overrides ``a.b.c=value`` (``+a.b=v`` to add, ``~a.b`` to delete)
* ``${a.b}`` interpolation (resolved eagerly at the end of composition)
* search-path extension via the ``SHEEPRL_SEARCH_PATH`` environment variable
  (reference hydra_plugins/sheeprl_search_path.py:26-33)

Composition is eager and deterministic; the result is a plain `Config` tree.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import yaml

from .container import Config, _parse_scalar, resolve_interpolations

CONFIG_ROOT = Path(__file__).resolve().parent.parent / "configs"


def _search_paths(extra: Optional[Sequence[Path]] = None) -> List[Path]:
    paths: List[Path] = []
    env = os.environ.get("SHEEPRL_SEARCH_PATH", "")
    for entry in env.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        # Hydra-style "file://<path>" entries are supported for compatibility.
        entry = entry.removeprefix("file://")
        p = Path(entry)
        if p.is_dir():
            paths.append(p)
    if extra:
        paths.extend(Path(p) for p in extra)
    paths.append(CONFIG_ROOT)
    return paths


def _find_config(rel: str, roots: Sequence[Path]) -> Optional[Path]:
    for root in roots:
        p = root / f"{rel}.yaml"
        if p.is_file():
            return p
        p = root / rel / "default.yaml"  # group dir with default
        if p.is_file():
            return p
    return None


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader with the YAML-1.2 float resolver, so `1e-3` parses as a
    float (PyYAML's default resolver misses dot-less scientific notation)."""


_ConfigLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    __import__("re").compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        __import__("re").X,
    ),
    list("-+0123456789."),
)


def _load_yaml(path: Path) -> Config:
    with open(path) as f:
        data = yaml.load(f, Loader=_ConfigLoader) or {}
    if not isinstance(data, Mapping):
        raise ValueError(f"Config file {path} must contain a mapping, got {type(data)}")
    return Config(data)


def _parse_default_entry(entry: Any) -> Tuple[Optional[str], Optional[str], bool, bool, bool]:
    """Return (group_path, option, is_self, optional, is_override) for a
    defaults-list entry."""
    if entry == "_self_":
        return None, None, True, False, False
    if isinstance(entry, str):
        # bare "group/option" include
        return entry, None, False, False, False
    if isinstance(entry, Mapping):
        if len(entry) != 1:
            raise ValueError(f"Malformed defaults entry: {entry}")
        key, value = next(iter(entry.items()))
        optional = False
        if key.startswith("optional "):
            optional = True
            key = key[len("optional "):]
        is_override = key.startswith("override ")
        key = key.removeprefix("override ")
        if isinstance(value, str) and value.endswith(".yaml"):
            value = value[: -len(".yaml")]
        return key, value, False, optional, is_override
    raise ValueError(f"Malformed defaults entry: {entry}")


def _collect_overrides(rel: str, roots: Sequence[Path], acc: Dict[str, str]) -> None:
    """Walk an exp file's bare-include chain collecting `override /group:
    option` entries (Hydra semantics: overrides rewrite the ROOT's group
    choice so the group composes once, *before* any exp-level content — they
    are not in-place merges). Outer files' overrides win over included ones."""
    path = _find_config(rel, roots)
    if path is None:
        return
    node = _load_yaml(path)
    base_dir = rel.rsplit("/", 1)[0] if "/" in rel else ""
    own: Dict[str, str] = {}
    for entry in node.get("defaults", []) or []:
        group, option, is_self, _, is_override = _parse_default_entry(entry)
        if is_self or group is None:
            continue
        if is_override and option is not None:
            plain = group.lstrip("/")
            own[plain] = option
        elif option is None:
            # bare include (exp chaining) — inner overrides collected first
            candidate = f"{base_dir}/{group}" if base_dir else group
            if _find_config(candidate, roots) is not None:
                _collect_overrides(candidate, roots, acc)
            else:
                _collect_overrides(group, roots, acc)
    acc.update(own)


def _compose_file(
    rel: str,
    roots: Sequence[Path],
    choices: Optional[Mapping[str, str]] = None,
    used_choices: Optional[set] = None,
) -> Config:
    """Load ``rel`` (group path, no extension) and recursively compose its defaults.

    ``choices`` maps group name → option selected on the CLI; a matching
    defaults-list entry uses the CLI option instead of the file's (Hydra's
    group-choice override semantics).
    """
    path = _find_config(rel, roots)
    if path is None:
        raise FileNotFoundError(
            f"Config '{rel}' not found under: {', '.join(str(r) for r in roots)}"
        )
    node = _load_yaml(path)
    defaults = node.pop("defaults", None)
    if defaults is None:
        return node

    base_dir = rel.rsplit("/", 1)[0] if "/" in rel else ""
    composed = Config()
    self_done = False
    for entry in defaults:
        group, option, is_self, optional, is_override = _parse_default_entry(entry)
        if is_self:
            composed.merge(node)
            self_done = True
            continue
        assert group is not None
        if is_override and used_choices is not None and option is not None:
            # the override rewrote the root's group choice (consumed there) —
            # nothing to merge at this position (Hydra semantics)
            plain = group.lstrip("/")
            if plain in used_choices:
                continue
        # group may carry an @dest package: "env@env2: default"
        dest = None
        if "@" in group:
            group, dest = group.split("@", 1)
        # CLI group choice supersedes the file's selection. Package-qualified
        # entries (group@dest) are only matched by the package-qualified
        # choice syntax `group@dest=option` (Hydra semantics: a bare override
        # does not rewrite packaged entries).
        if option is not None and choices:
            plain = group.lstrip("/")
            lookup = f"{plain}@{dest}" if dest is not None else plain
            if lookup in choices:
                option = choices[lookup]
                if used_choices is not None:
                    used_choices.add(lookup)
        if option is None:
            include_rel, dest_key = group, None
        else:
            if option in (None, "null"):
                continue
            include_rel = f"{group.lstrip('/')}/{option}"
            dest_key = dest if dest is not None else (None if group.startswith("/") else None)
            # Hydra packages group configs under the group name by default.
            if dest is None:
                dest_key = group.lstrip("/").split("/")[0]
        # Relative group resolution: groups referenced from inside exp/ files
        # with a leading "/" are absolute; bare names are relative to base_dir
        # first, then absolute.
        candidates = []
        if option is None:
            if base_dir:
                candidates.append(f"{base_dir}/{include_rel}")
            candidates.append(include_rel)
        elif group.startswith("/"):
            candidates.append(include_rel)
        else:
            if base_dir:
                candidates.append(f"{base_dir}/{include_rel}")
            candidates.append(include_rel)
        sub: Optional[Config] = None
        last_err: Optional[Exception] = None
        for cand in candidates:
            try:
                sub = _compose_file(cand, roots, choices, used_choices)
                break
            except FileNotFoundError as e:
                last_err = e
        if sub is None:
            if optional:
                continue
            raise last_err  # type: ignore[misc]
        if dest_key:
            target = composed
            for part in dest_key.split("."):
                if part not in target or not isinstance(target[part], Mapping):
                    target[part] = Config()
                target = target[part]
            target.merge(sub)
        else:
            composed.merge(sub)
    if not self_done:
        composed.merge(node)
    return composed


def _split_overrides(overrides: Sequence[str]) -> Tuple[List[Tuple[str, str]], List[Tuple[str, Any, str]]]:
    """Split CLI args into group selections (``group=option``) and value overrides.

    A ``k=v`` arg is a group selection when ``k`` names a config group directory
    (contains no dot and matches a directory under a search root).
    """
    groups: List[Tuple[str, str]] = []
    values: List[Tuple[str, Any, str]] = []
    roots = _search_paths()
    for ov in overrides:
        if ov.startswith("~"):
            values.append((ov[1:], None, "del"))
            continue
        mode = "set"
        if ov.startswith("++"):
            ov, mode = ov[2:], "add"
        elif ov.startswith("+"):
            ov, mode = ov[1:], "add"
        if "=" not in ov:
            raise ValueError(f"Malformed override '{ov}' (expected key=value)")
        key, _, raw = ov.partition("=")
        key = key.strip()
        is_group = False
        # `group=option` and the package-qualified `group@pkg.path=option`
        group_part = key.split("@", 1)[0]
        if mode == "set" and "." not in group_part and ("@" in key or "." not in key):
            for root in roots:
                if (root / group_part).is_dir():
                    is_group = True
                    break
        if is_group:
            groups.append((key, raw.strip()))
        else:
            values.append((key, _parse_scalar(raw), mode))
    return groups, values


def compose(
    config_name: str = "config",
    overrides: Optional[Sequence[str]] = None,
    extra_search_paths: Optional[Sequence[Path]] = None,
) -> Config:
    """Compose the full run config the way ``sheeprl exp=... a.b=c`` does."""
    overrides = list(overrides or [])
    roots = _search_paths(extra_search_paths)
    group_sel, value_ovs = _split_overrides(overrides)

    # Group selections (e.g. env=atari) supersede the matching defaults-list
    # entries wherever they appear (root or exp); the exp file composes at the
    # root package afterwards. Selections for groups no defaults entry names
    # are applied directly under their group key.
    choices = {g: o for g, o in group_sel if g != "exp"}
    exp_choice = dict(group_sel).get("exp")
    if exp_choice:
        # exp-file `override /group: option` entries rewrite the root's group
        # choices (outermost exp wins; CLI wins over all)
        exp_overrides: Dict[str, str] = {}
        _collect_overrides(f"exp/{exp_choice}", roots, exp_overrides)
        for g, o in exp_overrides.items():
            choices.setdefault(g, o)
    used: set = set()
    cfg = _compose_file(config_name, roots, choices, used)
    if exp_choice:
        cfg.merge(_compose_file(f"exp/{exp_choice}", roots, choices, used))
    for group, option in choices.items():
        if group not in used:
            plain, _, dest = group.partition("@")
            sub = _compose_file(f"{plain}/{option}", roots, choices, used)
            cfg.set_path(dest if dest else plain, sub)
    for key, value, mode in value_ovs:
        if mode == "del":
            parent = cfg.select(key.rsplit(".", 1)[0]) if "." in key else cfg
            leaf = key.rsplit(".", 1)[-1]
            if isinstance(parent, Mapping) and leaf in parent:
                del parent[leaf]
        else:
            # Hydra semantics: `a.b=v` sets a key the config has (a typo or a
            # knob the port does not read fails here); `+a.b=v` adds one
            cfg.set_path(key, value, force_add=mode == "add")
    resolve_interpolations(cfg)
    _validate_no_missing(cfg)
    return cfg


def _validate_no_missing(cfg: Config, prefix: str = "") -> None:
    for k, v in cfg.items():
        path = f"{prefix}{k}"
        if isinstance(v, Config):
            _validate_no_missing(v, prefix=f"{path}.")
        elif isinstance(v, str) and v == "???":
            raise ValueError(
                f"Mandatory config value '{path}' is missing — supply it on the "
                f"command line (e.g. `{path}=...`) or via an exp file."
            )


def load_config_file(path: os.PathLike) -> Config:
    """Load one resolved YAML file (a run's saved ``config.yaml``)."""
    return _load_yaml(Path(path))


def save_config(cfg: Config, path: os.PathLike) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
