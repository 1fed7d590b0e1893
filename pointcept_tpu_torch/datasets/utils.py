"""Collation into fixed-capacity PointBatch arrays (counterparts in
`pointcept_tpu/datasets/utils.py`). numpy only."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def offset2batch_np(offset: np.ndarray) -> np.ndarray:
    counts = np.diff(np.concatenate([[0], offset]))
    return np.repeat(np.arange(len(offset)), counts)


def collate_fn(batch: List[dict]) -> dict:
    """Ragged concat of the samples' arrays along the point dim; the per-sample
    `offset` becomes cumulative."""
    out = {}
    for key in batch[0].keys():
        vals = [np.asarray(b[key]) for b in batch]
        if key == "offset":
            out[key] = np.cumsum(np.concatenate(vals))
        else:
            out[key] = np.concatenate(vals, axis=0)
    return out


def pad_to_point_batch(batch: dict, capacity: int, num_scenes: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pad a collated ragged batch into fixed-capacity PointBatch arrays
    (coord/feat/grid_coord/batch/segment; padding has batch -1, label -1).
    Raises when the batch holds more points than `capacity`."""
    offset = np.asarray(batch["offset"])
    n_total = int(offset[-1])
    if n_total > capacity:
        raise ValueError(f"batch has {n_total} points > capacity {capacity}")
    if num_scenes is None:
        num_scenes = len(offset)
    n = capacity
    out: Dict[str, np.ndarray] = {}
    out["coord"] = np.zeros((n, 3), np.float32)
    out["coord"][:n_total] = np.asarray(batch["coord"], np.float32)
    if "feat" in batch:
        feat = np.asarray(batch["feat"], np.float32)
        out["feat"] = np.zeros((n, feat.shape[1]), np.float32)
        out["feat"][:n_total] = feat
    if "grid_coord" in batch:
        out["grid_coord"] = np.zeros((n, 3), np.int32)
        out["grid_coord"][:n_total] = np.asarray(batch["grid_coord"], np.int64).astype(np.int32)
    out["batch"] = np.full((n,), -1, np.int32)
    out["batch"][:n_total] = offset2batch_np(offset).astype(np.int32)
    if "segment" in batch:
        out["segment"] = np.full((n,), -1, np.int32)
        out["segment"][:n_total] = np.asarray(batch["segment"]).reshape(-1).astype(np.int32)
    out["num_scenes"] = num_scenes
    return out


def point_collate_fn(batch: List[dict], capacity: int):
    """Ragged concat, then static padding to `capacity` rows (Mix3D, a
    training option, is not ported)."""
    return pad_to_point_batch(collate_fn(batch), capacity, num_scenes=len(batch))
