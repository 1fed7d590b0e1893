"""Optimizer builder (counterpart of `pointcept_tpu/utils/optimizer.py`).

`param_dicts` entries like ``dict(keyword="block", lr=0.0006)`` route every
parameter whose dotted name contains the keyword into a group with its own
lr (the first matching entry wins), as the JAX package matches keywords on
flax paths (PTv3's "block lr x 0.1"). The port's names are the reference
Pointcept names, and a name holds "block" exactly where the flax path does.
Group 0 holds every other parameter at the base lr; group i + 1 is
``param_dicts[i]``, the order a OneCycle ``max_lr`` list follows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def param_groups(model: nn.Module, base_lr: float,
                 param_dicts: Optional[Sequence[dict]] = None) -> list:
    """[default group] + one group per `param_dicts` entry, each a dict of
    ``params``, ``names`` and ``lr``."""
    param_dicts = [dict(pd) for pd in (param_dicts or ())]
    groups = [dict(names=[], params=[], lr=base_lr)]
    groups += [dict(names=[], params=[], lr=float(pd.get("lr", base_lr))) for pd in param_dicts]
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        gi = next((i + 1 for i, pd in enumerate(param_dicts) if pd["keyword"] in name), 0)
        groups[gi]["names"].append(name)
        groups[gi]["params"].append(p)
    return groups


def freeze_except(model: nn.Module, keywords: Sequence[str]) -> None:
    """`trainable_keywords` with the reference's meaning: every parameter
    whose name holds none of `keywords` stops requiring gradients, so no
    param group holds it and no update (AdamW's decay included) moves it,
    where the JAX package's ``optax.masked`` still applies the raw
    gradients of the frozen tensors. A parameter already frozen stays
    frozen."""
    keywords = (keywords,) if isinstance(keywords, str) else tuple(keywords)
    for name, p in model.named_parameters():
        if not any(k in name for k in keywords):
            p.requires_grad_(False)


def build_optimizer(cfg: dict, model: nn.Module,
                    param_dicts: Optional[Sequence[dict]] = None) -> torch.optim.Optimizer:
    """``cfg = dict(type="AdamW", lr=..., weight_decay=..., betas=..., eps=...)``
    -> `torch.optim.AdamW`, or ``dict(type="SGD", lr=..., momentum=...,
    weight_decay=..., nesterov=...)`` -> `torch.optim.SGD`, over the keyword
    groups of `param_groups`. The JAX package's SGD chains
    ``add_decayed_weights -> trace(momentum, nesterov) -> lr``: the decay is
    added to the gradient and the trace starts at zero, which is torch's SGD
    with dampening 0. ``trainable_keywords`` freezes the model's other
    parameters first (`freeze_except`). Other optimizer types are not
    ported."""
    cfg = dict(cfg)
    otype = cfg.pop("type")
    if otype not in ("AdamW", "SGD"):
        raise NotImplementedError(f"build_optimizer: {otype} is not ported")
    base_lr = float(cfg.pop("lr"))
    cfg.pop("params", None)
    keywords = cfg.pop("trainable_keywords", None)
    if keywords:
        freeze_except(model, keywords)
    if otype == "SGD":
        if cfg.pop("dampening", 0.0):
            raise NotImplementedError("build_optimizer: SGD dampening is not ported")
        return torch.optim.SGD(
            param_groups(model, base_lr, param_dicts), lr=base_lr,
            momentum=cfg.pop("momentum", 0.9), weight_decay=cfg.pop("weight_decay", 0.0),
            nesterov=cfg.pop("nesterov", False), **cfg,
        )
    return torch.optim.AdamW(
        param_groups(model, base_lr, param_dicts), lr=base_lr,
        betas=tuple(cfg.pop("betas", (0.9, 0.999))), eps=cfg.pop("eps", 1e-8),
        weight_decay=cfg.pop("weight_decay", 0.01), **cfg,
    )
