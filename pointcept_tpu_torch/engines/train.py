"""Batch assembly (counterpart of `make_point_batch` in
`pointcept_tpu/engines/train.py`). The trainer is not ported yet."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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
