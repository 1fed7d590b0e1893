"""HOOKS registry (counterpart of `pointcept_tpu/engines/hooks/builder.py`)."""

from ...utils.registry import Registry

HOOKS = Registry("hooks")


def build_hooks(cfg):
    return [HOOKS.build(dict(h)) for h in cfg]
