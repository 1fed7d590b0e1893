"""Python-file config system with ``_base_`` inheritance (the port's own copy
of `pointcept_tpu/utils/config.py`: pure Python, the same dicts for every file
under `configs/`).

Behavior parity with the reference config loader (`pointcept/utils/config.py:70`):
configs are Python files executed as modules; a ``_base_ = ["..."]`` list pulls in
parent configs which are deep-merged (child wins); a ``_delete_=True`` key inside a
dict replaces the base dict instead of merging; ``merge_from_dict`` supports
dot-separated CLI overrides; ``DictAction`` parses ``key=value`` argparse options.
Clean-room implementation.
"""

from __future__ import annotations

import argparse
import ast
import copy
import importlib.util
import json
import os.path as osp
import pprint
import sys
import types
import uuid
from typing import Any, Dict, List, Optional

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"
RESERVED_KEYS = ("filename", "text")


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for d in args + (kwargs,):
            if d is None:
                continue
            for k, v in dict(d).items():
                self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"'ConfigDict' object has no attribute '{key}'") from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def update(self, *args, **kwargs):
        for d in args + (kwargs,):
            for k, v in dict(d).items():
                self[k] = v

    def copy(self):
        return ConfigDict(self)

    def to_dict(self) -> dict:
        def _unwrap(v):
            if isinstance(v, ConfigDict):
                return {k: _unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_unwrap(x) for x in v)
            return v

        return _unwrap(self)


def _exec_py_file(filename: str) -> Dict[str, Any]:
    """Execute a python config file and return its top-level variables."""
    with open(filename) as f:
        content = f.read()
    # validate syntax early with a clear error
    try:
        ast.parse(content)
    except SyntaxError as e:
        raise SyntaxError(f"Config file {filename} has a syntax error: {e}") from e
    module_name = f"_cfg_{uuid.uuid4().hex}"
    spec = importlib.util.spec_from_loader(module_name, loader=None, origin=filename)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = filename
    sys.modules[module_name] = mod
    try:
        exec(compile(content, filename, "exec"), mod.__dict__)
        cfg = {
            k: v
            for k, v in mod.__dict__.items()
            if not k.startswith("__") and not isinstance(v, (types.ModuleType, types.FunctionType, type))
        }
    finally:
        del sys.modules[module_name]
    return cfg


def _merge_a_into_b(a: dict, b: dict) -> dict:
    """Deep-merge dict a (child) into dict b (base); a wins. ``_delete_`` replaces."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and not v.pop(DELETE_KEY, False):
            if not isinstance(b[k], dict):
                raise TypeError(
                    f"Cannot merge dict into non-dict for key `{k}`: base has "
                    f"{type(b[k])}. Add `_delete_=True` to replace the base value."
                )
            b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = dict(v)
                v.pop(DELETE_KEY, None)
            b[k] = v
    return b


def _file2dict(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f"Config file not found: {filename}")
    ext = osp.splitext(filename)[1]
    if ext == ".py":
        cfg_dict = _exec_py_file(filename)
    elif ext == ".json":
        with open(filename) as f:
            cfg_dict = json.load(f)
    elif ext in (".yml", ".yaml"):
        import yaml

        with open(filename) as f:
            cfg_dict = yaml.safe_load(f)
    else:
        raise OSError(f"Only .py/.json/.yml/.yaml configs are supported, got {filename}")

    base = cfg_dict.pop(BASE_KEY, None)
    if base is not None:
        base_files = [base] if isinstance(base, str) else list(base)
        merged_base: Dict[str, Any] = {}
        for bf in base_files:
            b = _file2dict(osp.join(osp.dirname(filename), bf))
            dup = set(merged_base) & set(b)
            if dup:
                raise KeyError(f"Duplicate keys {dup} in multiple _base_ configs of {filename}")
            merged_base.update(b)
        cfg_dict = _merge_a_into_b(cfg_dict, merged_base)
    return cfg_dict


class Config:
    """A facade over a ConfigDict loaded from a file.

    Mirrors the reference `Config` API used throughout Pointcept:
    ``Config.fromfile``, attribute access, ``merge_from_dict``, ``dump``,
    ``pretty_text``.
    """

    def __init__(self, cfg_dict: Optional[dict] = None, filename: Optional[str] = None):
        if cfg_dict is None:
            cfg_dict = {}
        if not isinstance(cfg_dict, dict):
            raise TypeError(f"cfg_dict must be a dict, got {type(cfg_dict)}")
        for key in cfg_dict:
            if key in RESERVED_KEYS:
                raise KeyError(f"{key} is reserved for config file access")
        object.__setattr__(self, "_cfg_dict", ConfigDict(cfg_dict))
        object.__setattr__(self, "_filename", filename)

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_file2dict(filename), filename=filename)

    # -- mapping / attribute protocol ------------------------------------------------
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = value

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = value

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def __repr__(self):
        return f"Config (path: {self._filename}): {self._cfg_dict!r}"

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def values(self):
        return self._cfg_dict.values()

    def pop(self, name, default=None):
        return self._cfg_dict.pop(name, default)

    def setdefault(self, name, default=None):
        return self._cfg_dict.setdefault(name, default)

    def __deepcopy__(self, memo):
        other = Config()
        object.__setattr__(other, "_cfg_dict", copy.deepcopy(self._cfg_dict, memo))
        object.__setattr__(other, "_filename", self._filename)
        return other

    def copy(self):
        return copy.deepcopy(self)

    # -- merging ---------------------------------------------------------------------
    def merge_from_dict(self, options: dict):
        """Merge dot-separated-key overrides, e.g. ``{"model.backbone.depth": 4}``.

        Mirrors reference `utils/config.py:551`. List elements are addressable by
        integer segments, e.g. ``{"pipeline.0.type": "X"}``.
        """
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            key_list = full_key.split(".")
            for subkey in key_list[:-1]:
                d = d.setdefault(subkey, {})
            d[key_list[-1]] = v
        cfg_dict = self._cfg_dict.to_dict()
        merged = _merge_with_list_support(option_cfg, cfg_dict)
        object.__setattr__(self, "_cfg_dict", ConfigDict(merged))

    # -- export ----------------------------------------------------------------------
    @property
    def pretty_text(self) -> str:
        d = self._cfg_dict.to_dict()
        lines = []
        for k, v in d.items():
            lines.append(f"{k} = {pprint.pformat(v, width=100, sort_dicts=False)}")
        return "\n".join(lines) + "\n"

    def dump(self, file: Optional[str] = None):
        text = self.pretty_text
        if file is None:
            return text
        with open(file, "w") as f:
            f.write(text)
        return None


def _merge_with_list_support(a: dict, b: Any) -> Any:
    """Like _merge_a_into_b, but integer keys index into base lists."""
    if not isinstance(a, dict):
        return a
    int_keys = [k for k in a if isinstance(k, str) and k.lstrip("-").isdigit()]
    if isinstance(b, (list, tuple)) and int_keys:
        b = list(b)
        for k in list(a.keys()):
            i = int(k)
            if i >= len(b):
                raise KeyError(f"Index {i} exceeds list length {len(b)}")
            b[i] = _merge_with_list_support(a[k], b[i])
        return b
    if not isinstance(b, dict):
        return a
    out = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in out and not v.pop(DELETE_KEY, False):
            out[k] = _merge_with_list_support(v, out[k])
        else:
            out[k] = v
    return out


class DictAction(argparse.Action):
    """argparse action parsing ``KEY=VALUE`` pairs with literal-eval values.

    Mirrors reference `utils/config.py:600`: ``--options a.b=1 c=true d=1,2,3``
    yields ``{"a.b": 1, "c": True, "d": (1, 2, 3)}``.
    """

    @staticmethod
    def _parse_value(val: str):
        lowered = val.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            return val

    @staticmethod
    def _parse_iterable(val: str):
        """Parse value that may be a comma-separated tuple, honoring brackets."""

        def find_next_comma(s: str) -> int:
            depth = 0
            for i, ch in enumerate(s):
                if ch in "([{":
                    depth += 1
                elif ch in ")]}":
                    depth -= 1
                elif ch == "," and depth == 0:
                    return i
            return -1

        val = val.strip()
        if val.startswith("[") and val.endswith("]"):
            return [DictAction._parse_iterable(v) for v in _split_top(val[1:-1])] if val[1:-1] else []
        if val.startswith("(") and val.endswith(")"):
            return tuple(DictAction._parse_iterable(v) for v in _split_top(val[1:-1])) if val[1:-1] else ()
        if find_next_comma(val) >= 0:
            return tuple(DictAction._parse_iterable(v) for v in _split_top(val))
        return DictAction._parse_value(val)

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        if values is not None:
            for kv in values:
                key, sep, val = kv.partition("=")
                if not sep:
                    raise argparse.ArgumentError(self, f"expected KEY=VALUE, got {kv!r}")
                options[key.strip()] = self._parse_iterable(val)
        setattr(namespace, self.dest, options)


def _split_top(s: str) -> List[str]:
    """Split on top-level commas (not inside brackets)."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur or parts:
        parts.append("".join(cur))
    return [p for p in (x.strip() for x in parts) if p != ""]
