"""Segment reductions (counterpart of `pointcept_tpu/ops/segment_ops.py`)."""

from __future__ import annotations

import torch


def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                   reduce: str = "sum") -> torch.Tensor:
    """Reduce rows of `data` by segment id; ids >= num_segments are dropped.

    reduce in {sum, mean, max}. Empty segments give 0 for every reduction."""
    ids = torch.clamp(segment_ids.long(), max=num_segments)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    idx = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    if reduce == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device).index_add_(0, ids, data)
    elif reduce == "mean":
        s = torch.zeros(shape, dtype=data.dtype, device=data.device).index_add_(0, ids, data)
        c = torch.zeros(num_segments + 1, dtype=data.dtype, device=data.device).index_add_(
            0, ids, torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
        )
        out = s / torch.clamp(c, min=1).view((-1,) + (1,) * (data.dim() - 1))
    elif reduce == "max":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device).scatter_reduce_(
            0, idx, data, reduce="amax", include_self=False
        )
    else:
        raise ValueError(f"unknown reduce {reduce}")
    return out[:num_segments]
