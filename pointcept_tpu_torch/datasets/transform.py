"""Host-side numpy transforms of the serving path (counterparts in
`pointcept_tpu/datasets/transform.py`): CenterShift, GridSample (train mode),
SphereCrop (center mode), NormalizeColor and Collect."""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from ..utils.registry import Registry

TRANSFORMS = Registry("transforms")

DEFAULT_INDEX_VALID_KEYS = ["coord", "color", "normal", "superpoint", "strength", "segment", "instance"]


def index_operator(data_dict, index):
    """Apply an index selection to every key in index_valid_keys."""
    if "index_valid_keys" not in data_dict:
        data_dict["index_valid_keys"] = list(DEFAULT_INDEX_VALID_KEYS)
    for key in data_dict["index_valid_keys"]:
        if key in data_dict:
            data_dict[key] = data_dict[key][index]
    return data_dict


class Compose:
    """Sequential transform pipeline built from a list of cfg dicts."""

    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.transforms = [TRANSFORMS.build(dict(t)) for t in self.cfg]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict


@TRANSFORMS.register_module()
class Collect:
    """Pick keys, emit the offset, concatenate feat_keys."""

    def __init__(self, keys, offset_keys_dict=None, **kwargs):
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.offset_keys = offset_keys_dict if offset_keys_dict is not None else dict(offset="coord")
        self.kwargs = kwargs

    def __call__(self, data_dict):
        data = {key: data_dict[key] for key in self.keys}
        for key, value in self.offset_keys.items():
            data[key] = np.array([data_dict[value].shape[0]])
        for name, keys in self.kwargs.items():
            assert isinstance(keys, Sequence)
            data[name.replace("_keys", "")] = np.concatenate(
                [np.asarray(data_dict[key], dtype=np.float32) for key in keys], axis=1
            )
        return data


@TRANSFORMS.register_module()
class NormalizeColor:
    def __call__(self, data_dict):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 255
        return data_dict


@TRANSFORMS.register_module()
class CenterShift:
    def __init__(self, apply_z=True):
        self.apply_z = apply_z

    def __call__(self, data_dict):
        if "coord" in data_dict:
            x_min, y_min, z_min = data_dict["coord"].min(axis=0)
            x_max, y_max, _ = data_dict["coord"].max(axis=0)
            shift = [(x_min + x_max) / 2, (y_min + y_max) / 2, z_min if self.apply_z else 0]
            data_dict["coord"] = data_dict["coord"] - shift
        return data_dict


@TRANSFORMS.register_module()
class GridSample:
    """Hash-based voxel sampling, train mode: one random point per voxel.
    Draws from `rng` (a numpy RandomState; the global numpy state when None)."""

    def __init__(self, grid_size=0.05, hash_type="fnv", mode="train", return_grid_coord=False,
                 rng=None, keys=None):
        if mode != "train" or hash_type != "fnv":
            raise NotImplementedError("GridSample: only train mode with the fnv hash is ported")
        self.grid_size = grid_size
        self.return_grid_coord = return_grid_coord
        self.rng = rng

    def __call__(self, data_dict):
        rng = self.rng if self.rng is not None else np.random
        scaled = data_dict["coord"] / self.grid_size
        grid = np.floor(scaled).astype(np.int64)
        grid = grid - grid.min(0)
        key = self.fnv_hash_vec(grid)
        order = np.argsort(key)
        sk = key[order]
        head = np.empty(sk.shape[0], bool)
        head[0] = True
        np.not_equal(sk[1:], sk[:-1], out=head[1:])
        starts = np.flatnonzero(head)
        counts = np.diff(np.append(starts, sk.shape[0]))
        picked = order[starts + rng.randint(0, counts.max(), counts.size) % counts]
        data_dict = index_operator(data_dict, picked)
        if self.return_grid_coord:
            data_dict["grid_coord"] = grid[picked]
            if "grid_coord" not in data_dict["index_valid_keys"]:
                data_dict["index_valid_keys"] = list(data_dict["index_valid_keys"]) + ["grid_coord"]
        return data_dict

    @staticmethod
    def fnv_hash_vec(arr):
        """Row-wise FNV-1a (64-bit offset basis / prime)."""
        arr = np.ascontiguousarray(arr, dtype=np.uint64)
        h = np.full(arr.shape[0], np.uint64(0xCBF29CE484222325))
        for col in arr.T:
            h = (h * np.uint64(0x100000001B3)) ^ col
        return h


@TRANSFORMS.register_module()
class SphereCrop:
    """Keep the `point_max` points nearest to the center point (center mode)."""

    def __init__(self, point_max=80000, mode="center"):
        if mode != "center":
            raise NotImplementedError("SphereCrop: only center mode is ported")
        self.point_max = point_max

    def __call__(self, data_dict):
        n = data_dict["coord"].shape[0]
        if n > self.point_max:
            center = data_dict["coord"][n // 2]
            idx_crop = np.argsort(np.sum(np.square(data_dict["coord"] - center), 1))[: self.point_max]
            data_dict = index_operator(data_dict, idx_crop)
        return data_dict

