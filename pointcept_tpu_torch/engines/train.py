"""Batch assembly and the train step (counterparts of `make_point_batch` and
`build_train_step` in `pointcept_tpu/engines/train.py`). The hook-driven
trainer, checkpoints, logging and evaluation are not ported yet."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.utils.structure import PointBatch
from ..utils.device import resolve_device


def make_point_batch(arrays: Dict[str, np.ndarray], num_scenes: int, device=None) -> PointBatch:
    """Collated arrays (numpy or tensors) -> PointBatch on `device` (the GPU
    unless the caller names another; raises when no GPU is present and none
    is named)."""
    device = resolve_device(device)

    def put(key, dtype):
        a = arrays.get(key)
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(device, dtype)

    return PointBatch(
        coord=put("coord", torch.float32),
        feat=put("feat", torch.float32),
        grid_coord=put("grid_coord", torch.int32),
        batch=put("batch", torch.int32),
        segment=put("segment", torch.int32),
        num_scenes=num_scenes,
    )


def _total(values) -> torch.Tensor:
    return torch.stack(list(values)).sum() if values else torch.zeros((), dtype=torch.int32)


def build_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
                     clip_grad: Optional[float] = None) -> Callable:
    """One optimisation step on one device: forward in train mode (the
    segmentor's summed criteria), backward, optional clip of the global
    gradient norm, the optimizer step, then one scheduler step.

    Returns ``step(pb, generator) -> {"loss", "pool_overflow",
    "block_overflow"}``, all 0-d tensors on the model's device: the step
    itself never waits for the card, the caller reads the scalars when it
    wants them. `generator` draws the order shuffles and drop-path masks.
    The parameters' ``.grad`` hold the step's gradients until the next step."""

    def step(pb: PointBatch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        res = model(pb, generator=generator)
        res["loss"].backward()
        if clip_grad is not None:
            nn.utils.clip_grad_norm_(model.parameters(), clip_grad)
        optimizer.step()
        scheduler.step()
        diag = res["diagnostics"]
        return {"loss": res["loss"].detach(), "pool_overflow": _total(diag["pool_overflow"]),
                "block_overflow": _total(diag["block_overflow"])}

    return step
