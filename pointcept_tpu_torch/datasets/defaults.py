"""DefaultDataset: a directory of .npy scenes through a transform pipeline
(counterpart of `pointcept_tpu/datasets/defaults.py`; parity target:
reference `pointcept/datasets/defaults.py:34-199`).

A scene is a directory ``data_root/split/<scene>/`` holding ``coord.npy``
(float32 [N, 3]) and optional ``color``, ``normal``, ``strength``,
``segment`` and ``instance`` arrays. The train path (`test_mode=False`)
applies the pipeline; the test path (`test_mode=True`) builds the tester's
fragment list: the pipeline, then each `aug_transform` view of a copy of the
scene, its `voxelize` fragments (GridSample's test mode) and optional
`crop`, each through `post_transform`.
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
from .transform import TRANSFORMS, Compose


@DATASETS.register_module()
class DefaultDataset:
    VALID_ASSETS = ["coord", "color", "normal", "strength", "segment", "instance", "pose", "superpoint"]

    def __init__(self, split="train", data_root="data/dataset", transform=None, test_mode=False,
                 test_cfg=None, cache=False, ignore_index=-1, loop=1, extra_transform=None):
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
        self.loop = 1 if test_mode else loop
        self.test_mode = test_mode
        self._cache_store = {}
        if test_mode:
            test_cfg = dict(test_cfg or {})
            self.test_voxelize = (TRANSFORMS.build(dict(test_cfg["voxelize"]))
                                  if test_cfg.get("voxelize") else None)
            self.test_crop = TRANSFORMS.build(dict(test_cfg["crop"])) if test_cfg.get("crop") else None
            self.post_transform = Compose(list(test_cfg.get("post_transform") or []))
            self.aug_transform = [Compose(aug) for aug in test_cfg.get("aug_transform", [[]])]
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

    def prepare_test_data(self, idx) -> dict:
        """The scene's fragment list for the tester: ``segment``, ``name``
        (with ``origin_segment`` and ``inverse`` where the pipeline keeps the
        full-resolution labels), a sample's ``category`` or ``cls_token``
        where it has one (the part-seg testers' masks) and
        ``fragment_list``."""
        data_dict = self.transform(self.get_data(idx))
        result = dict(segment=data_dict.pop("segment"), name=data_dict.pop("name"))
        for key in ("category", "cls_token"):
            if key in data_dict:
                result[key] = data_dict.pop(key)
        if "origin_segment" in data_dict:
            if "inverse" not in data_dict:
                raise KeyError("DefaultDataset: origin_segment needs the pipeline's inverse")
            result["origin_segment"] = data_dict.pop("origin_segment")
            result["inverse"] = data_dict.pop("inverse")
        fragments = []
        for aug in self.aug_transform:
            data = aug(deepcopy(data_dict))
            if self.test_voxelize is not None:
                parts = self.test_voxelize(data)
            else:
                data["index"] = np.arange(data["coord"].shape[0])
                parts = [data]
            for part in parts:
                if self.test_crop is not None:
                    part = self.test_crop(part)
                fragments += part if isinstance(part, list) else [part]
        result["fragment_list"] = [self.post_transform(f) for f in fragments]
        return result

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_data(idx)
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
