from .device import resolve_device
from .optimizer import build_optimizer
from .registry import Registry, build_from_cfg
from .scheduler import build_scheduler

__all__ = ["Registry", "build_from_cfg", "build_optimizer", "build_scheduler", "resolve_device"]
