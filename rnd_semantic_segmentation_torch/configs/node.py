"""YACS-compatible typed config tree (a copy of the JAX package's configs/node.py).

Merge semantics: ``cfg.merge_from_file(yaml)`` ->
``cfg.merge_from_list([KEY, VALUE, ...])`` -> ``cfg.freeze()``, with
dotted-key addressing (``SOLVER.BASE_LR``) and type coercion of CLI string
values against the default tree.

PyYAML is imported only by ``merge_from_file`` and ``dump``: a config built
from the defaults plus a ``KEY VALUE`` list needs no YAML parser.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List


class ConfigError(Exception):
    pass


_VALID_SCALAR_TYPES = (int, float, bool, str, type(None))


class CfgNode(dict):
    """A dict with attribute access, freezing, and YACS-style merging."""

    __slots__ = ()
    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__  # noqa: B018 (documentation only)
        dict.__setitem__(self, CfgNode._FROZEN_KEY, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"Config has no key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if name != CfgNode._FROZEN_KEY and self.is_frozen():
            raise ConfigError(f"Cannot set {name!r}: config is frozen")
        dict.__setitem__(self, name, value)

    # -- freeze protocol -----------------------------------------------------
    def freeze(self) -> "CfgNode":
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        dict.__setitem__(self, CfgNode._FROZEN_KEY, True)
        return self

    def defrost(self) -> "CfgNode":
        dict.__setitem__(self, CfgNode._FROZEN_KEY, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return dict.get(self, CfgNode._FROZEN_KEY, False)

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            if k == CfgNode._FROZEN_KEY:
                continue
            dict.__setitem__(out, k, v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v))
        return out

    # -- merging --------------------------------------------------------------
    def merge_from_file(self, path: str) -> "CfgNode":
        import yaml

        with open(path) as fh:
            loaded = yaml.safe_load(fh) or {}
        self._merge_dict(loaded, prefix="")
        return self

    def merge_from_other_cfg(self, other: "CfgNode") -> "CfgNode":
        self._merge_dict(other.to_dict(), prefix="")
        return self

    def merge_from_list(self, opts: List[str]) -> "CfgNode":
        if len(opts) % 2 != 0:
            raise ConfigError(f"Override list must be KEY VALUE pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node, leaf = self._resolve(key, create=False)
            node[leaf] = _coerce(value, node.get(leaf))
        return self

    def _merge_dict(self, d: Dict[str, Any], prefix: str) -> None:
        for k, v in d.items():
            full = f"{prefix}{k}"
            if isinstance(v, dict):
                sub = self.get(k)
                if sub is None:
                    sub = CfgNode()
                    self[k] = sub
                if not isinstance(sub, CfgNode):
                    raise ConfigError(f"Cannot merge dict into non-dict key {full!r}")
                sub._merge_dict(v, prefix=full + ".")
            else:
                old = self.get(k)
                if isinstance(old, CfgNode):
                    raise ConfigError(f"Cannot overwrite config section {full!r} with scalar")
                self[k] = _check_value(v, old, full)

    def _resolve(self, dotted: str, create: bool):
        parts = dotted.split(".")
        node: CfgNode = self
        for p in parts[:-1]:
            nxt = node.get(p)
            if nxt is None:
                if not create:
                    raise ConfigError(f"Unknown config key {dotted!r}")
                nxt = CfgNode()
                node[p] = nxt
            if not isinstance(nxt, CfgNode):
                raise ConfigError(f"Config key {dotted!r} traverses a scalar")
            node = nxt
        return node, parts[-1]

    # -- export ----------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            if k == CfgNode._FROZEN_KEY:
                continue
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.dump()


def _check_value(value: Any, old: Any, key: str) -> Any:
    if isinstance(value, (list, tuple)):
        return type(value)(value)
    if not isinstance(value, _VALID_SCALAR_TYPES):
        raise ConfigError(f"Unsupported config value type {type(value)} at {key!r}")
    # mild type reconciliation against the default tree
    if old is not None and value is not None:
        if isinstance(old, bool) and not isinstance(value, bool):
            raise ConfigError(f"Type mismatch at {key!r}: expected bool, got {value!r}")
        if isinstance(old, float) and isinstance(value, int):
            value = float(value)
        if isinstance(old, float) and isinstance(value, str):
            # YAML 1.1 parses "5e-4" (no dot) as a string; the repo's
            # configs use that spelling (configs/deeplabv2_r101_src_kvasir.yaml:17)
            try:
                value = float(value)
            except ValueError:
                raise ConfigError(f"Type mismatch at {key!r}: expected float, got {value!r}")
        if isinstance(old, (tuple, list)) and isinstance(value, (tuple, list)):
            value = type(old)(value)
    return value


def _coerce(raw: str, old: Any) -> Any:
    """Parse a CLI string like YACS does: literal_eval, falling back to str."""
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw
    if old is not None and value is not None:
        if isinstance(old, bool):
            if isinstance(value, str):
                lowered = value.lower()
                if lowered in ("true", "false"):
                    value = lowered == "true"
            if not isinstance(value, bool):
                raise ConfigError(f"Expected bool for override, got {raw!r}")
        elif isinstance(old, float) and isinstance(value, int):
            value = float(value)
        elif isinstance(old, (tuple, list)) and isinstance(value, (tuple, list)):
            value = type(old)(value)
    return value
