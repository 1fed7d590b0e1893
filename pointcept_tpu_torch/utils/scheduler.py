"""LR schedule builder (counterpart of `pointcept_tpu/utils/scheduler.py`):
per-step `torch.optim.lr_scheduler.OneCycleLR`, which
tests/test_torch_parity.py holds against the JAX package's pure schedule,
`PolyLR` (tests/test_torch_port_indoor.py), `CosineAnnealingLR` and
`MultiStepLR` (tests/test_torch_port_cls.py). Other LR schedules are not
ported. `CosineScheduler` schedules the
hyperparameters of SSL models (`SonataHook`)."""

from __future__ import annotations

import math

import numpy as np
import torch


class CosineScheduler:
    """A value schedule over `total_steps`: a linear warm-up from
    `start_warmup_value` to `base_value` over `warmup_steps`, then a cosine
    from `base_value` to `final_value`. `step()` returns the value at
    `iter` and advances it; past the end the last value holds."""

    def __init__(self, base_value, final_value, total_steps, warmup_steps=0, start_warmup_value=0):
        warmup = np.linspace(start_warmup_value, base_value, warmup_steps) if warmup_steps > 0 else np.array([])
        iters = np.arange(total_steps - warmup_steps)
        cosine = final_value + 0.5 * (base_value - final_value) * (1 + np.cos(np.pi * iters / len(iters)))
        self.schedule = np.concatenate((warmup, cosine))
        self.total_steps = total_steps
        self.iter = 0

    def __getitem__(self, it):
        return self.schedule[min(it, self.total_steps - 1)]

    def step(self):
        value = self[self.iter]
        self.iter += 1
        return value


def poly_lr(optimizer: torch.optim.Optimizer, total_steps: int, power: float = 0.9):
    """PolyLR: each param group's lr times ``(1 - step / (total_steps + 1)) **
    power`` at step `step` (the JAX package's ``base_lr`` is the optimizer's
    lr, and its `param_dicts` groups take the same factor of their own)."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: (1 - step / (total_steps + 1)) ** power)


def cosine_annealing_lr(optimizer: torch.optim.Optimizer, total_steps: int, eta_min: float = 0.0,
                        base_lr: float = 1.0):
    """CosineAnnealingLR: ``eta_min + (base_lr - eta_min) * (1 + cos(pi *
    step / total_steps)) / 2`` at step `step`, `base_lr` the optimizer's lr;
    a param group of another lr takes the same curve scaled by its lr /
    `base_lr` (the JAX package's group multipliers)."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda step: (eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * step / total_steps))) / base_lr)


def multi_step_lr(optimizer: torch.optim.Optimizer, total_steps: int, milestones, gamma: float = 0.1):
    """MultiStepLR: each param group's lr times `gamma` once for every
    milestone ``int(r * total_steps)`` (the config's `milestones` are
    fractions of the run) that `step` has reached."""
    bounds = sorted(int(r * total_steps) for r in milestones)
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: gamma ** sum(step >= m for m in bounds))


def build_scheduler(cfg: dict, optimizer: torch.optim.Optimizer, total_steps: int):
    """``cfg = dict(type="PolyLR", power=0.9)``,
    ``dict(type="CosineAnnealingLR", eta_min=..., base_lr=...)``,
    ``dict(type="MultiStepLR", milestones=[0.6, 0.8], gamma=0.1)``, or
    ``cfg = dict(type="OneCycleLR", max_lr=..., pct_start=..., ...)``; a
    `max_lr` list gives each param group its own peak (group order of
    `build_optimizer`). Momentum is not cycled: the JAX package's schedule
    accepts `cycle_momentum` and ignores it, and the port keeps its numbers."""
    cfg = dict(cfg)
    stype = cfg.pop("type")
    if stype == "PolyLR":
        cfg.pop("base_lr", None)  # the optimizer's groups hold their lrs
        return poly_lr(optimizer, total_steps, **cfg)
    if stype == "CosineAnnealingLR":
        return cosine_annealing_lr(optimizer, total_steps, **cfg)
    if stype == "MultiStepLR":
        cfg.pop("base_lr", None)
        return multi_step_lr(optimizer, total_steps, **cfg)
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
