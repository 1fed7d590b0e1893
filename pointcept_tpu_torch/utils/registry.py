"""String -> class registries driving the config system.

The port's own copy of `pointcept_tpu/utils/registry.py` (the port imports
nothing of the JAX package): ``Registry.build(dict(type="Name", **kwargs))``
instantiates the registered class, so a model dict builds with either
package under the same type names.
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Type


def build_from_cfg(cfg: dict, registry: "Registry", default_args: Optional[dict] = None):
    """Instantiate an object from ``cfg = dict(type=..., **kwargs)``.

    ``type`` may be a registered string name or a class/callable;
    ``default_args`` fill missing keys.
    """
    if not isinstance(cfg, Mapping):
        raise TypeError(f"cfg must be a dict, got {type(cfg)}")
    if "type" not in cfg:
        if default_args is None or "type" not in default_args:
            raise KeyError(f'`cfg` or `default_args` must contain the key "type", got {cfg}')
    if default_args is not None and not isinstance(default_args, Mapping):
        raise TypeError(f"default_args must be a dict or None, got {type(default_args)}")

    args = dict(cfg)
    if default_args is not None:
        for name, value in default_args.items():
            args.setdefault(name, value)

    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or valid type, got {type(obj_type)}")
    try:
        return obj_cls(**args)
    except Exception as e:  # re-raise with context about which class failed
        raise type(e)(f"{obj_cls.__name__}: {e}") from e


class Registry:
    """A string-keyed registry of classes/callables."""

    def __init__(self, name: str, build_func: Callable = build_from_cfg):
        self._name = name
        self._module_dict: Dict[str, Any] = {}
        self.build_func = build_func

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Optional[Type]:
        return self._module_dict.get(key)

    def build(self, cfg: dict, default_args: Optional[dict] = None):
        return self.build_func(cfg, self, default_args=default_args)

    def _register(self, module: Any, name=None, force: bool = False):
        if name is None:
            name = module.__name__
        names = [name] if isinstance(name, str) else list(name)
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} is already registered in {self._name}")
            self._module_dict[n] = module

    def register_module(self, name=None, force: bool = False, module: Any = None):
        """Register a class, usable as decorator (with or without arguments)."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator
