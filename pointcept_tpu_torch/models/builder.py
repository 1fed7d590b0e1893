"""Model registry and builder (counterpart of `pointcept_tpu/models/builder.py`)."""

from __future__ import annotations

import inspect
from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.registry import Registry

MODELS = Registry("models")


def build_model(cfg: dict, device=None, generator: Optional[torch.Generator] = None):
    """Build dict(type=..., **kwargs) in eval mode on `device` (the GPU unless
    the caller names another; raises when no GPU is present and none is
    named). Weights are drawn from `generator` (seed 0 when omitted); a
    model whose weights start as copies of others (Sonata's teacher) makes
    them in its `post_init`."""
    from .modules import init_weights

    device = resolve_device(device)
    model = MODELS.build(cfg)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    if hasattr(model, "post_init"):
        model.post_init()
    return model.to(device).eval()


def apply_amp_policy(model_cfg: dict, enable_amp: bool) -> dict:
    """Fold the config's `enable_amp` into a backbone that has a bf16
    activation stream: a (shallow) copy of `model_cfg` with ``amp=True`` in
    the backbone when its registered class takes `amp` and the config does
    not set it (counterpart of `pointcept_tpu/models/builder.py:14`)."""
    model_cfg = dict(model_cfg)
    bb = model_cfg.get("backbone")
    if not enable_amp or not isinstance(bb, dict) or "type" not in bb:
        return model_cfg
    cls = MODELS.get(bb["type"])
    # the arguments of every __init__ up the class chain (PT-v3m3's passes the rest on)
    takes = set() if cls is None else {name for c in cls.__mro__ if "__init__" in vars(c)
                                       for name in inspect.signature(c.__init__).parameters}
    if "amp" in takes and "amp" not in bb:
        model_cfg["backbone"] = dict(bb, amp=True)
    return model_cfg
