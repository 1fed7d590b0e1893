"""DefaultDataset: a directory of .npy scenes through a transform pipeline
(counterpart of `pointcept_tpu/datasets/defaults.py`; parity target:
reference `pointcept/datasets/defaults.py:34-199`).

A scene is a directory ``data_root/split/<scene>/`` holding ``coord.npy``
(float32 [N, 3]) and optional ``color``, ``normal``, ``strength``,
``segment`` and ``instance`` arrays. The train path (`test_mode=False`)
applies the pipeline; the tester's fragment path (`test_mode=True`) is not
ported.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from collections.abc import Sequence
from copy import deepcopy

import numpy as np

from ..utils.logger import get_root_logger
from .builder import DATASETS, build_dataset
from .transform import Compose

@DATASETS.register_module()
class DefaultDataset:
    VALID_ASSETS = ["coord", "color", "normal", "strength", "segment", "instance", "pose", "superpoint"]

    def __init__(self, split="train", data_root="data/dataset", transform=None, test_mode=False,
                 test_cfg=None, cache=False, ignore_index=-1, loop=1, extra_transform=None):
        if test_mode:
            raise NotImplementedError("DefaultDataset: test_mode (the tester's fragments) is not ported")
        self.data_root = data_root
        self.split = split
        # extra_transform splices in before the terminal Collect, as the JAX package
        if extra_transform:
            transform = list(transform or [])
            cut = next((i for i, t in enumerate(transform) if dict(t).get("type") == "Collect"),
                       len(transform))
            transform = transform[:cut] + list(extra_transform) + transform[cut:]
        self.transform = Compose(transform)
        self.cache = cache
        self.ignore_index = ignore_index
        self.loop = loop
        self.test_mode = test_mode
        self._cache_store = {}
        self.data_list = self.get_data_list()
        get_root_logger().info(f"Totally {len(self.data_list)} x {self.loop} samples in {split} set.")

    def get_data_list(self):
        if isinstance(self.split, str):
            return sorted(glob.glob(osp.join(self.data_root, self.split, "*")))
        if isinstance(self.split, Sequence):
            out = []
            for split in self.split:
                out += sorted(glob.glob(osp.join(self.data_root, split, "*")))
            return out
        raise NotImplementedError

    def load_assets(self, idx) -> dict:
        """name, split and every .npy of the scene directory whose name is
        in VALID_ASSETS."""
        path = self.data_list[idx % len(self.data_list)]
        data_dict = dict(name=self.get_data_name(idx), split=self.get_split_name(idx))
        for asset in os.listdir(path) if osp.isdir(path) else []:
            key = asset[: -len(".npy")]
            if asset.endswith(".npy") and key in self.VALID_ASSETS:
                data_dict[key] = np.load(osp.join(path, asset))
        return data_dict

    def get_data(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        if self.cache and path in self._cache_store:
            return deepcopy(self._cache_store[path])
        data_dict = self.load_assets(idx)
        n = data_dict["coord"].shape[0]
        for key in ("coord", "color", "normal"):
            if key in data_dict:
                data_dict[key] = data_dict[key].astype(np.float32)
        for key in ("segment", "instance"):
            if key in data_dict:
                data_dict[key] = data_dict[key].reshape([-1]).astype(np.int32)
            else:
                data_dict[key] = np.ones(n, dtype=np.int32) * -1
        if self.cache:
            self._cache_store[path] = deepcopy(data_dict)
        return data_dict

    def get_data_name(self, idx):
        return osp.basename(self.data_list[idx % len(self.data_list)])

    def get_split_name(self, idx):
        return osp.basename(osp.dirname(self.data_list[idx % len(self.data_list)]))

    def __getitem__(self, idx):
        return self.transform(self.get_data(idx))

    def __len__(self):
        return len(self.data_list) * self.loop


@DATASETS.register_module()
class ConcatDataset:
    """Concatenation of sub-datasets (reference `defaults.py:640-676`)."""

    def __init__(self, datasets, loop=1):
        self.datasets = [build_dataset(dict(d)) for d in datasets]
        self.loop = loop
        self.data_list = [(i, j) for i, d in enumerate(self.datasets) for j in range(len(d))]

    def __getitem__(self, idx):
        dataset_idx, data_idx = self.data_list[idx % len(self.data_list)]
        return self.datasets[dataset_idx][data_idx]

    def __len__(self):
        return len(self.data_list) * self.loop
