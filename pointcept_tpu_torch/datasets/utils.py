"""Collation into fixed-capacity PointBatch arrays (counterparts in
`pointcept_tpu/datasets/utils.py`): ragged concat, Mix3D scene fusion, then
static padding, of one point set a sample or of the views of SSL samples.
numpy only."""

from __future__ import annotations

import random
from collections.abc import Mapping
from typing import Dict, List, Optional

import numpy as np


def offset2batch_np(offset: np.ndarray) -> np.ndarray:
    counts = np.diff(np.concatenate([[0], offset]))
    return np.repeat(np.arange(len(offset)), counts)


def collate_fn(batch: List[dict]) -> dict:
    """Ragged concat along the point dim; the per-sample `offset` becomes
    cumulative. A string value is the first sample's; the samples'
    ``condition`` (PPT: one dataset a batch) must agree, or it raises."""
    assert isinstance(batch[0], Mapping)
    out = {}
    for key in batch[0].keys():
        vals = [b[key] for b in batch]
        if key == "offset" or key.endswith("_offset"):
            acc, cum = [], 0
            for v in vals:
                acc.append(np.asarray(v) + cum)
                cum += int(np.asarray(v)[-1])
            out[key] = np.concatenate(acc)
        elif isinstance(vals[0], np.ndarray) and vals[0].ndim >= 1:
            out[key] = np.concatenate(vals, axis=0)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        elif isinstance(vals[0], str):
            if key == "condition" and len(set(vals)) > 1:
                raise ValueError(f"collate: one batch mixes the conditions {sorted(set(vals))}")
            out[key] = vals[0]
        else:
            out[key] = vals
    return out


def mix3d(batch: dict) -> dict:
    """Mix3D scene fusion: merge scene pairs by dropping every other offset
    (reference `point_collate_fn`, `datasets/utils.py:234-239`). Instance
    ids of the second scene of a pair are shifted past the first's."""
    offset = batch["offset"]
    if "instance" in batch:
        start = 0
        num_instance = 0
        inst = batch["instance"]
        for i in range(len(offset)):
            if i % 2 == 0:
                num_instance = max(inst[start : offset[i]].max(initial=0) + 1, 0)
            else:
                seg = inst[start : offset[i]]
                batch["instance"][start : offset[i]] = np.where(seg != -1, seg + num_instance, seg)
            start = offset[i]
    for key in [k for k in batch if k == "offset" or k.endswith("_offset")]:
        o = batch[key]
        batch[key] = np.concatenate([o[1:-1:2], o[-1:]])
    if "grid_coord" in batch and "grid_size" in batch:
        b = offset2batch_np(batch["offset"])
        gs = np.asarray(batch["grid_size"]).reshape(-1)[0]
        grid = np.floor(batch["coord"] / gs).astype(np.int64)
        mins = np.full((batch["offset"].shape[0], 3), np.iinfo(np.int64).max)
        np.minimum.at(mins, b, grid)
        batch["grid_coord"] = grid - mins[b]
    return batch


def pad_to_point_batch(batch: dict, capacity: int, num_scenes: Optional[int] = None,
                       drop_overflow: bool = True) -> Dict[str, np.ndarray]:
    """Pad a collated ragged batch into fixed-capacity PointBatch arrays
    (coord/feat/grid_coord/batch/segment, and instance, instance_centroid,
    the batch's ``condition`` and each scene's ``category`` or ``cls_token``
    where present; padding has batch -1, label -1, centroid -1.0, category
    and cls_token -1). A batch
    of more points than `capacity` is subsampled uniformly at random
    (`np.random.choice`, as the JAX package's training collate), or raises
    without `drop_overflow`."""
    offset = np.asarray(batch["offset"])
    n_total = int(offset[-1])
    b_ids = offset2batch_np(offset).astype(np.int32)
    if num_scenes is None:
        num_scenes = len(offset)
    keep = None
    if n_total > capacity:
        if not drop_overflow:
            raise ValueError(f"batch has {n_total} points > capacity {capacity}")
        keep = np.sort(np.random.choice(n_total, capacity, replace=False))

    def _sel(a):
        return a if keep is None else a[keep]

    n = capacity
    eff = min(n_total, capacity)
    out: Dict[str, np.ndarray] = {}
    out["coord"] = np.zeros((n, 3), np.float32)
    out["coord"][:eff] = _sel(np.asarray(batch["coord"], np.float32))
    if "feat" in batch:
        feat = _sel(np.asarray(batch["feat"], np.float32))
        out["feat"] = np.zeros((n, feat.shape[1]), np.float32)
        out["feat"][:eff] = feat
    if "grid_coord" in batch:
        out["grid_coord"] = np.zeros((n, 3), np.int32)
        out["grid_coord"][:eff] = _sel(np.asarray(batch["grid_coord"], np.int64)).astype(np.int32)
    out["batch"] = np.full((n,), -1, np.int32)
    out["batch"][:eff] = _sel(b_ids)
    for key in ("segment", "instance"):
        if key in batch:
            out[key] = np.full((n,), -1, np.int32)
            out[key][:eff] = _sel(np.asarray(batch[key]).reshape(-1).astype(np.int32))
    if "instance_centroid" in batch:
        out["instance_centroid"] = np.full((n, 3), -1.0, np.float32)
        out["instance_centroid"][:eff] = _sel(np.asarray(batch["instance_centroid"], np.float32))
    if "condition" in batch:
        out["condition"] = batch["condition"]
    for key in ("category", "cls_token"):
        if key in batch:
            # one class a scene; scenes past the batch's samples carry -1
            v = np.asarray(batch[key]).reshape(-1).astype(np.int32)
            out[key] = np.full((num_scenes,), -1, np.int32)
            out[key][: len(v)] = v
    out["num_scenes"] = num_scenes
    return out


def point_collate_fn(batch: List[dict], capacity: int, mix_prob: float = 0.0, drop_overflow: bool = True):
    """The collate of the trainer's loaders: ragged concat, Mix3D with
    probability `mix_prob` (drawn with python's `random.random()`, as the
    JAX package), then static padding to `capacity` rows. A batch of more
    points than `capacity` is subsampled at random, or raises without
    `drop_overflow` (the eval's loaders: a metric of a subsampled scene is
    not the scene's). Multi-view batches (``{prefix}_offset`` keys) take
    Mix3D view-wise (scene pairs merged in every view) and
    `pad_views_to_point_batch`."""
    num_scenes = len(batch)
    merged = collate_fn(batch)
    if any(k.endswith("_offset") and k != "offset" for k in merged):
        if mix_prob > 0 and random.random() < mix_prob:
            for key in [k for k in merged if k.endswith("_offset")]:
                o = merged[key]
                merged[key] = np.concatenate([o[1:-1:2], o[-1:]])
        return pad_views_to_point_batch(merged, capacity, num_scenes=num_scenes, drop_overflow=drop_overflow)
    if mix_prob > 0 and random.random() < mix_prob:
        merged = mix3d(merged)
    return pad_to_point_batch(merged, capacity, num_scenes=num_scenes, drop_overflow=drop_overflow)


VIEW_SUFFIXES = ("coord", "grid_coord", "origin_coord", "color", "normal", "feat", "segment")


def pad_views_to_point_batch(batch: dict, capacity: int, num_scenes: Optional[int] = None,
                             drop_overflow: bool = True) -> Dict[str, np.ndarray]:
    """Pad each view set of a multi-view batch (``global_*``, ``local_*``,
    delimited by ``{prefix}_offset``) into `capacity` rows:
    ``{prefix}_batch`` (the view's index, -1 padding) and each
    ``{prefix}_{suffix}`` of `VIEW_SUFFIXES` present (padding 0, or -1 for
    segments). A view set of more points than `capacity` is subsampled
    uniformly at random (one `np.random.choice` a view set, as the JAX
    package), or raises without `drop_overflow`; ``dropped`` counts the
    points subsampled away over the view sets."""
    out: Dict[str, np.ndarray] = {}
    prefixes = sorted({k[: -len("_offset")] for k in batch if k.endswith("_offset") and k != "offset"})
    assert prefixes, "no view offsets found"
    if num_scenes is None:
        num_scenes = len(np.asarray(batch[f"{prefixes[0]}_offset"]))
    dropped = 0
    for prefix in prefixes:
        offset = np.asarray(batch[f"{prefix}_offset"])
        n_total = int(offset[-1])
        b_ids = offset2batch_np(offset).astype(np.int32)
        keep = None
        if n_total > capacity:
            if not drop_overflow:
                raise ValueError(f"{prefix} views have {n_total} points > capacity {capacity}")
            keep = np.sort(np.random.choice(n_total, capacity, replace=False))
            dropped += n_total - capacity

        def _sel(a):
            return a if keep is None else a[keep]

        eff = min(n_total, capacity)
        out[f"{prefix}_batch"] = np.full((capacity,), -1, np.int32)
        out[f"{prefix}_batch"][:eff] = _sel(b_ids)
        for suf in VIEW_SUFFIXES:
            key = f"{prefix}_{suf}"
            if key not in batch:
                continue
            a = _sel(np.asarray(batch[key]))
            if suf in ("grid_coord", "segment"):
                a = a.astype(np.int32)
                padded = np.full((capacity,) + a.shape[1:], 0 if suf == "grid_coord" else -1, np.int32)
            else:
                a = a.astype(np.float32)
                padded = np.zeros((capacity,) + a.shape[1:], np.float32)
            padded[:eff] = a
            out[key] = padded
    out["num_scenes"] = num_scenes
    out["dropped"] = dropped
    return out
