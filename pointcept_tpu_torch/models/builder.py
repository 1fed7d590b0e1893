"""Model registry and builder (counterpart of `pointcept_tpu/models/builder.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.registry import Registry

MODELS = Registry("models")


def build_model(cfg: dict, device=None, generator: Optional[torch.Generator] = None):
    """Build dict(type=..., **kwargs) in eval mode on `device` (the GPU unless
    the caller names another; raises when no GPU is present and none is
    named). Weights are drawn from `generator` (seed 0 when omitted)."""
    from .modules import init_weights

    device = resolve_device(device)
    model = MODELS.build(cfg)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device).eval()
