"""nuScenes lidarseg (counterpart of `pointcept_tpu/datasets/nuscenes.py`;
parity target: reference `pointcept/datasets/nuscenes.py`).

The preprocessed info layout: ``data_root/info/nuscenes_infos_{sweeps}sweeps_{split}.pkl``,
each a pickled list of dicts with ``lidar_path`` (float32 [N, 5] under
``data_root/raw``: x, y, z, intensity 0-255, ring), ``lidar_token`` (the
lidar sample_data token, which names the submission's files) and, where
labelled, ``gt_segment_path`` (uint8 lidarseg ids of the 32 categories,
mapped to the challenge's 16 classes). A sweep without labels gets
`ignore_index`. Its name is the lidar file's stem.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset
from .semantic_kitti import map_labels


@DATASETS.register_module()
class NuScenesDataset(DefaultDataset):
    def __init__(self, sweeps=10, ignore_index=-1, **kwargs):
        self.sweeps = sweeps
        self.learning_map = self.get_learning_map(ignore_index)
        self.learning_map_inv = self.get_learning_map_inv(ignore_index)
        super().__init__(ignore_index=ignore_index, **kwargs)

    def get_info_path(self, split):
        assert split in ("train", "val", "test")
        return os.path.join(self.data_root, "info", f"nuscenes_infos_{self.sweeps}sweeps_{split}.pkl")

    def get_data_list(self):
        data_list = []
        for split in [self.split] if isinstance(self.split, str) else self.split:
            info_path = self.get_info_path(split)
            if os.path.isfile(info_path):
                with open(info_path, "rb") as f:
                    data_list += pickle.load(f)
        return data_list

    def get_data(self, idx):
        data = self.data_list[idx % len(self.data_list)]
        points = np.fromfile(os.path.join(self.data_root, "raw", data["lidar_path"]),
                             dtype=np.float32).reshape([-1, 5])
        if "gt_segment_path" in data:
            raw = np.fromfile(os.path.join(self.data_root, "raw", data["gt_segment_path"]), dtype=np.uint8)
            segment = map_labels(raw, self.learning_map)
        else:
            segment = np.full(points.shape[0], self.ignore_index, dtype=np.int32)
        # intensity scaled to [0, 1]
        return dict(coord=points[:, :3], strength=points[:, 3].reshape([-1, 1]) / 255, segment=segment,
                    name=self.get_data_name(idx))

    def get_data_name(self, idx):
        return os.path.basename(self.data_list[idx % len(self.data_list)]["lidar_path"]).split(".")[0]

    def lidar_token(self, name: str) -> str:
        """The lidar sample_data token of the sweep named `name`."""
        if not hasattr(self, "_tokens"):
            self._tokens = {os.path.basename(d["lidar_path"]).split(".")[0]: d.get("lidar_token")
                            for d in self.data_list}
        token = self._tokens.get(name)
        if token is None:
            raise KeyError(f"NuScenesDataset: no lidar_token in the info of {name!r}; the lidarseg submission "
                           f"names its files by it")
        return token

    @staticmethod
    def get_learning_map(ignore_index):
        """The 32 lidarseg categories -> the challenge's 16 classes (0-15)."""
        return {
            0: ignore_index, 1: ignore_index, 2: 6, 3: 6, 4: 6, 5: ignore_index,
            6: 6, 7: ignore_index, 8: ignore_index, 9: 0, 10: ignore_index, 11: ignore_index,
            12: 7, 13: ignore_index, 14: 1, 15: 2, 16: 2, 17: 3, 18: 4,
            19: ignore_index, 20: ignore_index, 21: 5, 22: 8, 23: 9, 24: 10,
            25: 11, 26: 12, 27: 13, 28: 14, 29: ignore_index, 30: 15, 31: ignore_index,
        }

    @staticmethod
    def get_learning_map_inv(ignore_index):
        """The 16 classes -> a canonical lidarseg category id of each (the
        JAX package's submission ids; the challenge takes class + 1)."""
        return {
            ignore_index: 0, 0: 9, 1: 14, 2: 15, 3: 17, 4: 18, 5: 21, 6: 2,
            7: 12, 8: 22, 9: 23, 10: 24, 11: 25, 12: 26, 13: 27, 14: 28, 15: 30,
        }
