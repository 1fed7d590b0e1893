"""LR schedule builder (counterpart of `pointcept_tpu/utils/scheduler.py`):
per-step `torch.optim.lr_scheduler.OneCycleLR`, which
tests/test_torch_parity.py holds against the JAX package's pure schedule.
Other schedules are not ported."""

from __future__ import annotations

import torch


def build_scheduler(cfg: dict, optimizer: torch.optim.Optimizer, total_steps: int):
    """``cfg = dict(type="OneCycleLR", max_lr=..., pct_start=..., ...)``; a
    `max_lr` list gives each param group its own peak (group order of
    `build_optimizer`). Momentum is not cycled: the JAX package's schedule
    accepts `cycle_momentum` and ignores it, and the port keeps its numbers."""
    cfg = dict(cfg)
    stype = cfg.pop("type")
    if stype != "OneCycleLR":
        raise NotImplementedError(f"build_scheduler: {stype} is not ported")
    cfg.pop("cycle_momentum", None)
    cfg.pop("base_momentum", None)
    cfg.pop("max_momentum", None)
    cfg.pop("base_lr", None)
    max_lr = cfg.pop("max_lr")
    if isinstance(max_lr, (list, tuple)) and len(max_lr) != len(optimizer.param_groups):
        raise ValueError(f"OneCycleLR: {len(max_lr)} max_lr values for "
                         f"{len(optimizer.param_groups)} param groups")
    return torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=list(max_lr) if isinstance(max_lr, (list, tuple)) else max_lr,
        total_steps=total_steps, cycle_momentum=False, **cfg,
    )
