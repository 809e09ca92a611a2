"""Attribute-accessible nested dict container used for all configs.

The port's own copy of ``sheeprl_tpu/config/container.py``.

Replaces the reference's OmegaConf/`dotdict` (sheeprl/utils/utils.py `dotdict`,
cli.py:364) with a plain-Python container: after composition the config is an
inert tree of ``Config`` nodes — no lazy interpolation, no runtime surprises,
trivially picklable.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config(dict):
    """A dict with attribute access and deep conversion.

    ``cfg.algo.lr`` == ``cfg["algo"]["lr"]``. Missing attribute access raises
    AttributeError (not KeyError) so ``getattr(cfg, "x", default)`` works.
    """

    def __init__(self, data: Optional[Mapping[str, Any]] = None, **kwargs: Any):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    # -- conversion --------------------------------------------------------
    @staticmethod
    def _convert(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, list):
            return [Config._convert(v) for v in value]
        if isinstance(value, tuple):
            return [Config._convert(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._convert(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __deepcopy__(self, memo: Dict[int, Any]) -> "Config":
        out = Config()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    # -- dotted-path access ------------------------------------------------
    def select(self, path: str, default: Any = None) -> Any:
        """Get ``a.b.c`` style path; returns ``default`` when missing."""
        node: Any = self
        for part in path.split("."):
            if isinstance(node, list):
                try:
                    node = node[int(part)]
                except (ValueError, IndexError):
                    return default
            elif isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, path: str, value: Any, *, force_add: bool = True) -> None:
        """Set ``a.b.c`` style path, creating intermediate Config nodes."""
        parts = path.split(".")
        node: Config = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, Mapping):
                if not force_add and part not in node:
                    raise KeyError(f"Cannot set '{path}': '{part}' does not exist")
                nxt = Config()
                node[part] = nxt
            node = node[part]  # type: ignore[assignment]
        if not force_add and parts[-1] not in node:
            raise KeyError(f"Cannot set '{path}': key '{parts[-1]}' does not exist")
        node[parts[-1]] = value

    # -- merging -----------------------------------------------------------
    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Deep-merge ``other`` on top of self (in place). Lists replace."""
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), Mapping):
                self[k].merge(v)  # type: ignore[union-attr]
            else:
                self[k] = v
        return self

    def to_dict(self) -> Dict[str, Any]:
        def conv(v: Any) -> Any:
            if isinstance(v, Mapping):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return conv(self)  # type: ignore[return-value]


_FLOAT_RE = re.compile(r"^[-+]?(\d[\d_]*)([eE][-+]?\d+)$")


def _parse_scalar(text: str) -> Any:
    """Parse a scalar the way YAML would (used for interpolation results and CLI overrides)."""
    import yaml

    try:
        out = yaml.safe_load(text)
    except Exception:
        return text
    # YAML-1.2 float forms PyYAML misses (`1e-3`)
    if isinstance(out, str) and _FLOAT_RE.match(out):
        return float(out)
    return out


def resolve_interpolations(root: Config, max_passes: int = 10) -> Config:
    """Resolve ``${a.b.c}`` references against the root config, in place.

    Mirrors OmegaConf interpolation semantics used throughout the reference
    configs (e.g. ``exp_name: ${algo.name}_${env.id}``,
    reference configs/config.yaml:56-58). Unresolvable references raise.
    """

    def walk(node: Any) -> Iterator[Tuple[Any, Any, Any]]:
        if isinstance(node, Mapping):
            for k, v in list(node.items()):
                yield node, k, v
                yield from walk(v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield node, i, v
                yield from walk(v)

    for _ in range(max_passes):
        changed = False
        pending = False
        for parent, key, value in walk(root):
            if not isinstance(value, str) or "${" not in value:
                continue
            matches = list(_INTERP_RE.finditer(value))
            if not matches:
                pending = True  # nested ${${...}} — unsupported, flag below
                continue
            resolvable = True
            # ${now:FMT} resolver (reference run_name uses it).
            if any(m.group(1).strip().startswith("now:") for m in matches):
                import datetime

                out = value
                for m in matches:
                    ref = m.group(1).strip()
                    if ref.startswith("now:"):
                        out = out.replace(
                            m.group(0), datetime.datetime.now().strftime(ref[len("now:"):])
                        )
                parent[key] = out
                changed = True
                continue
            # Full-string single interpolation keeps the referenced type.
            if len(matches) == 1 and matches[0].span() == (0, len(value)):
                ref = matches[0].group(1).strip()
                target = root.select(ref, default=_MISSING)
                if target is _MISSING:
                    resolvable = False
                elif isinstance(target, str) and "${" in target:
                    pending = True
                    continue
                else:
                    parent[key] = target
                    changed = True
                    continue
            # String-embedded interpolation(s).
            out = value
            for m in matches:
                ref = m.group(1).strip()
                target = root.select(ref, default=_MISSING)
                if target is _MISSING or (isinstance(target, str) and "${" in target):
                    resolvable = False
                    break
                out = out.replace(m.group(0), str(target))
            if resolvable and out != value:
                parent[key] = out
                changed = True
            elif not resolvable:
                pending = True
        if not changed:
            if pending:
                # One more sweep to produce a precise error message.
                for _, _, value in walk(root):
                    if isinstance(value, str) and "${" in value:
                        for m in _INTERP_RE.finditer(value):
                            ref = m.group(1).strip()
                            if root.select(ref, default=_MISSING) is _MISSING:
                                raise KeyError(f"Unresolvable interpolation '${{{ref}}}' in '{value}'")
            break
    return root


class _Missing:
    def __repr__(self) -> str:  # pragma: no cover
        return "<MISSING>"


_MISSING = _Missing()
