"""Synthetic ScanNet-like scenes (counterparts of `synthesize_scene` and
`SyntheticSemSegDataset` in `pointcept_tpu/datasets/synthetic.py`): floor and
wall planes plus furniture surface shells, deterministic per seed; and
`SyntheticClsDataset`'s class-dependent clouds. numpy only."""

from __future__ import annotations

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset


def synthesize_scene(seed: int, num_points: int = 120000, num_classes: int = 20, extent: float = 8.0):
    rng = np.random.RandomState(seed)
    n_floor = num_points // 4
    n_wall = num_points // 4
    n_obj = num_points - n_floor - n_wall
    floor = np.stack(
        [rng.uniform(0, extent, n_floor), rng.uniform(0, extent, n_floor), np.abs(rng.normal(0, 0.02, n_floor))],
        axis=1,
    )
    w1 = np.stack(
        [rng.uniform(0, extent, n_wall // 2), np.abs(rng.normal(0, 0.02, n_wall // 2)), rng.uniform(0, 3, n_wall // 2)],
        axis=1,
    )
    w2 = np.stack(
        [np.abs(rng.normal(0, 0.02, n_wall - n_wall // 2)), rng.uniform(0, extent, n_wall - n_wall // 2),
         rng.uniform(0, 3, n_wall - n_wall // 2)],
        axis=1,
    )
    # furniture: surface shells (half boxes, half ellipsoids), as real scans are 2-manifolds
    n_blobs = rng.randint(5, 15)
    centers = rng.uniform(0.5, extent - 0.5, size=(n_blobs, 3))
    centers[:, 2] = rng.uniform(0.2, 1.5, n_blobs)
    sizes = rng.uniform(0.2, 1.0, size=(n_blobs, 3))
    blob_ids = rng.randint(0, n_blobs, n_obj)
    dirs = rng.normal(0, 1, (n_obj, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
    shell = dirs / np.maximum(np.abs(dirs), 1e-6).max(axis=1, keepdims=True)
    is_box = (blob_ids % 2)[:, None]
    surf = np.where(is_box, shell, dirs)
    objs = centers[blob_ids] + surf * sizes[blob_ids] * 0.5 + rng.normal(0, 0.004, (n_obj, 3))
    coord = np.concatenate([floor, w1, w2, objs]).astype(np.float32)

    seg = np.concatenate(
        [np.full(n_floor, 1), np.full(n_wall, 0), (blob_ids % (num_classes - 2)) + 2]
    ).astype(np.int32)
    inst = np.concatenate([np.full(n_floor, -1), np.full(n_wall, -1), blob_ids]).astype(np.int32)
    color = (rng.rand(len(coord), 3) * 55 + np.eye(3)[seg % 3] * 200).astype(np.float32)
    normal = rng.randn(len(coord), 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-9
    perm = rng.permutation(len(coord))
    return dict(coord=coord[perm], color=color[perm], normal=normal[perm], segment=seg[perm], instance=inst[perm])


@DATASETS.register_module()
class SyntheticSemSegDataset(DefaultDataset):
    """`num_scenes` scenes of `synthesize_scene`, scene i from seed
    `seed_offset + i`, through the transform pipeline."""

    def __init__(self, num_scenes=8, num_points=120000, num_classes=20, seed_offset=0, extent=8.0,
                 **kwargs):
        self.num_scenes = num_scenes
        self.num_points = num_points
        self.num_classes = num_classes
        self.seed_offset = seed_offset
        self.extent = extent
        kwargs.setdefault("data_root", "")
        super().__init__(**kwargs)

    def get_data_list(self):
        return [f"synthetic_{self.split}_{i}" for i in range(self.num_scenes)]

    def get_data(self, idx):
        i = idx % len(self.data_list)
        data = synthesize_scene(self.seed_offset + i, self.num_points, self.num_classes, extent=self.extent)
        data["name"] = self.data_list[i]
        data["split"] = self.split
        return data

    def get_data_name(self, idx):
        return self.data_list[idx % len(self.data_list)]


@DATASETS.register_module()
class SyntheticClsDataset(DefaultDataset):
    """`num_clouds` clouds for classification: cloud i of class ``i %
    num_classes``, `num_points` points scattered (sigma 0.1) around the 8
    anchors of its class (drawn from ``RandomState(class)``), from
    ``RandomState(seed_offset + i)``, with random unit normals."""

    def __init__(self, num_clouds=64, num_points=1024, num_classes=40, seed_offset=0, **kwargs):
        self.num_clouds = num_clouds
        self.num_points = num_points
        self.num_classes = num_classes
        self.seed_offset = seed_offset
        kwargs.setdefault("data_root", "/nonexistent")
        super().__init__(**kwargs)

    def get_data_list(self):
        return [f"cls_{self.split}_{i}" for i in range(self.num_clouds)]

    def get_data(self, idx):
        i = idx % len(self.data_list)
        rng = np.random.RandomState(self.seed_offset + i)
        category = i % self.num_classes
        anchors = np.random.RandomState(category).uniform(-1, 1, size=(8, 3))
        a_ids = rng.randint(0, 8, self.num_points)
        coord = (anchors[a_ids] + rng.normal(0, 0.1, (self.num_points, 3))).astype(np.float32)
        normal = rng.randn(self.num_points, 3).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-9
        return dict(coord=coord, normal=normal, segment=np.full(self.num_points, -1, np.int32),
                    category=np.array([category], np.int32), name=self.data_list[i], split=self.split)

    def get_data_name(self, idx):
        return self.data_list[idx % len(self.data_list)]


def _collate(samples, capacity):
    from .utils import collate_fn, pad_to_point_batch

    return pad_to_point_batch(collate_fn(samples), capacity, drop_overflow=False)


def _pipeline(grid_size, crop_points, rng):
    """The synthetic benchmark batch's transforms: CenterShift, GridSample in
    train mode (drawing from `rng`), optional center SphereCrop, CenterShift,
    NormalizeColor, Collect (coord, grid_coord, segment; color + normal)."""
    from .transform import Compose

    steps = [
        dict(type="CenterShift", apply_z=True),
        dict(type="GridSample", grid_size=grid_size, mode="train", return_grid_coord=True, rng=rng),
    ]
    if crop_points:
        steps.append(dict(type="SphereCrop", point_max=crop_points, mode="center"))
    steps += [
        dict(type="CenterShift", apply_z=False),
        dict(type="NormalizeColor"),
        dict(type="Collect", keys=("coord", "grid_coord", "segment"), feat_keys=("color", "normal")),
    ]
    return Compose(steps)


def synthetic_arrays(capacity, num_scenes, seed=0, num_classes=13, grid_size=0.05,
                     oversample=1.0, extent=8.0, crop=False, rng=None):
    """One collated fixed-capacity batch of synthetic scenes (seeds `seed`,
    `seed + 1`, ...) through `_pipeline`, labels kept. GridSample draws from
    `rng` (the global numpy state when None)."""
    pipeline = _pipeline(grid_size, capacity // max(num_scenes, 1) if crop else 0, rng)
    per_scene = max(256, int(capacity * oversample) // max(num_scenes, 1))
    samples = []
    for i in range(num_scenes):
        data = synthesize_scene(seed + i, num_points=per_scene, num_classes=num_classes, extent=extent)
        samples.append(pipeline(data))
    return _collate(samples, capacity)


def scene_batch(seeds, points_per_scene=102400, num_classes=20, grid_size=0.02, oversample=4.0,
                extent=6.0):
    """One labelled batch of ScanNet-like scenes, one per seed, each made as
    the single-scene batch of that seed: `oversample` x `points_per_scene`
    raw points in an `extent` m room, GridSample drawing from
    `RandomState(seed)`, center-cropped to `points_per_scene`. Capacity
    len(seeds) * points_per_scene; padding rows carry batch and label -1."""
    samples = []
    for seed in seeds:
        pipeline = _pipeline(grid_size, points_per_scene, np.random.RandomState(seed))
        data = synthesize_scene(seed, num_points=int(points_per_scene * oversample),
                                num_classes=num_classes, extent=extent)
        samples.append(pipeline(data))
    return _collate(samples, points_per_scene * len(seeds))
