"""Hierarchical config node.

A fresh, minimal re-implementation of the configuration-tree capability the
reference gets from its vendored YACS (`src/config/yacs.py` — CfgNode,
merge, type-coerced overrides). Not a port: plain dict subclass with
attribute access, YAML I/O, dotted-key overrides and type coercion.
"""

from __future__ import annotations

import copy
from typing import Any

from . import yaml_io

_VALID_SCALARS = (int, float, bool, str, type(None))


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Coerce ``new`` to the type of ``old`` where it is safe to do so.

    Mirrors the reference semantics (yacs.py:443-483): str<->scalar parsing
    for CLI overrides, int->float widening, list/tuple interchange.
    """
    if old is None or new is None:
        return new
    if isinstance(new, str) and not isinstance(old, str):
        parsed = yaml_io.safe_load(new)
        if isinstance(parsed, str):
            # yaml 1.1 misses floats like "1e-3"; try numeric parse
            try:
                parsed = float(parsed)
            except ValueError:
                pass
        if isinstance(parsed, str):
            raise ValueError(
                f"type mismatch for key '{key}': cannot coerce str ({new!r}) "
                f"to {type(old).__name__} ({old!r})"
            )
        return _coerce(parsed, old, key)
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if type(old) is type(new) or isinstance(new, type(old)) or isinstance(old, type(new)):
        return new
    raise ValueError(
        f"type mismatch for key '{key}': cannot coerce {type(new).__name__} "
        f"({new!r}) to {type(old).__name__} ({old!r})"
    )


class CN(dict):
    """Config node: a dict with attribute access and merge semantics.

    Also carries the reference-yacs capability extras (yacs.py:64-282):
    freeze/defrost immutability and a deprecated/renamed key registry
    consulted during merges.
    """

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_deprecated_keys", set())
        object.__setattr__(self, "_renamed_keys", {})
        if init:
            for k, v in init.items():
                self[k] = self._convert(v)

    # -- immutability (yacs freeze/defrost) ----------------------------------
    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, CN):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, CN):
                v.defrost()

    def is_frozen(self) -> bool:
        return getattr(self, "_frozen", False)

    def __setitem__(self, key, value):
        if getattr(self, "_frozen", False):
            raise AttributeError(
                f"attempted to set '{key}' on a frozen CN (call defrost())")
        super().__setitem__(key, value)

    # -- deprecated / renamed key registry (yacs.py registry capability) -----
    def register_deprecated_key(self, key: str):
        self._deprecated_keys.add(key)

    def register_renamed_key(self, old: str, new: str):
        self._renamed_keys[old] = new

    def _check_key_status(self, key: str) -> str | None:
        """Returns the effective key, or None if deprecated (dropped)."""
        if key in getattr(self, "_deprecated_keys", ()):  # noqa: B909
            print(f"[config] ignoring deprecated key: {key}")
            return None
        if key in getattr(self, "_renamed_keys", {}):
            new = self._renamed_keys[key]
            print(f"[config] key '{key}' was renamed to '{new}'")
            return new
        return key

    @staticmethod
    def _convert(v: Any) -> Any:
        if isinstance(v, CN):
            return v
        if isinstance(v, dict):
            return CN(v)
        if isinstance(v, list):
            return [CN._convert(x) for x in v]
        return v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._convert(value)

    def __delattr__(self, name: str) -> None:
        del self[name]

    # -- merging ------------------------------------------------------------
    def merge_from_other(self, other: "CN | dict") -> None:
        """Recursively merge ``other`` into self (other wins)."""
        for k, v in other.items():
            k = self._check_key_status(k)
            if k is None:
                continue
            if k in self and isinstance(self[k], CN) and isinstance(v, dict):
                self[k].merge_from_other(v)
            elif k in self:
                self[k] = self._convert(_coerce(v, self[k], k))
            else:
                self[k] = self._convert(v)

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = yaml_io.safe_load(f)
        if data is None:
            return
        self.merge_from_other(data)

    def merge_from_list(self, opts: list) -> None:
        """Merge a flat ``[key, value, key, value, ...]`` override list.

        Keys may be dotted (``train.lr``). Values are YAML-parsed and
        coerced to the type of any existing value (reference:
        yacs.py:177-219 merge_from_list).
        """
        if len(opts) % 2 != 0:
            raise ValueError(f"override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CN):
                    node[p] = CN()
                node = node[p]
            leaf = parts[-1]
            old = node.get(leaf, None)
            new = yaml_io.safe_load(value) if isinstance(value, str) else value
            node[leaf] = self._convert(_coerce(new, old, key) if leaf in node else new)

    # -- misc ---------------------------------------------------------------
    def clone(self) -> "CN":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, CN):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, CN) else x for x in v]
            else:
                out[k] = v
        return out

    def dump(self) -> str:
        return yaml_io.safe_dump(self.to_dict())

    def __deepcopy__(self, memo):
        new = CN()
        for k, v in self.items():
            new[k] = copy.deepcopy(v, memo)
        return new

    def __repr__(self) -> str:  # pragma: no cover
        return f"CN({dict.__repr__(self)})"
