"""ModelNet40 (counterpart of `pointcept_tpu/datasets/modelnet.py`; parity
target: reference `pointcept/datasets/modelnet.py`).

The `modelnet40_normal_resampled` layout: ``<category>/<name>.txt`` point
lists (x, y, z, nx, ny, nz, comma-separated), the split files
``modelnet40_{split}.txt`` (one sample name a line) and the category list
`class_names_file`.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from ..ops.pointops import fps_numpy
from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class ModelNetDataset(DefaultDataset):
    """A sample of more than `num_points` points keeps `num_points` of
    them: farthest point sampling on the host (`uniform_sampling`, as the
    reference's `farthest_point_sampling`), seeded by the last four bytes of
    the sample's name, or its first `num_points`. ``category`` [1] is the
    index of its category in the names file; ``segment`` is -1. With
    `save_record` each sample's sampled points stay in memory after its
    first read (the reference writes the split's records to disk, the JAX
    package keeps nothing): the voting tester reads each cloud once, not
    once a repeat."""

    def __init__(self, num_points: int = 8192, uniform_sampling: bool = True, save_record: bool = True,
                 class_names_file: str = "modelnet40_shape_names.txt", **kwargs):
        self.num_points = num_points
        self.uniform_sampling = uniform_sampling
        self.save_record = save_record
        self.class_names_file = class_names_file
        self.categories = None
        self._records = {}
        super().__init__(**kwargs)
        names_path = osp.join(self.data_root, self.class_names_file)
        if osp.isfile(names_path):
            with open(names_path) as f:
                self.categories = [line.strip() for line in f]

    def get_data_list(self):
        split_file = osp.join(self.data_root, f"modelnet40_{self.split}.txt")
        if not osp.isfile(split_file):
            return []
        with open(split_file) as f:
            return [line.strip() for line in f]

    def get_data(self, idx):
        name = self.data_list[idx % len(self.data_list)]
        if name not in self._records:
            self._records[name] = self._read(name)
            if not self.save_record:
                return self._records.pop(name)
        return {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in self._records[name].items()}

    def _read(self, name: str) -> dict:
        category = "_".join(name.split("_")[:-1])
        raw = np.loadtxt(osp.join(self.data_root, category, name + ".txt"), delimiter=",").astype(np.float32)
        if self.num_points is not None and raw.shape[0] > self.num_points:
            if self.uniform_sampling:
                seed = int.from_bytes(name.encode()[-4:].rjust(4, b"\0"), "little")
                raw = raw[fps_numpy(raw[:, :3], self.num_points, seed=seed)]
            else:
                raw = raw[: self.num_points]
        cat_idx = self.categories.index(category) if self.categories else 0
        return dict(coord=raw[:, :3], normal=raw[:, 3:6], segment=np.full(raw.shape[0], -1, np.int32),
                    category=np.array([cat_idx], np.int32), name=name, split=self.split)

    def get_data_name(self, idx):
        return self.data_list[idx % len(self.data_list)]
