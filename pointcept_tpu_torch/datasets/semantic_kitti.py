"""SemanticKITTI (counterpart of `pointcept_tpu/datasets/semantic_kitti.py`;
parity target: reference `pointcept/datasets/semantic_kitti.py`).

Raw scans under ``data_root/dataset/sequences/<seq>/velodyne/<frame>.bin``
(float32 [N, 4]: x, y, z, remission) and, where labelled,
``labels/<frame>.label`` (uint32: the semantic id in the low 16 bits, the
instance id in the high 16). The semantic ids go through the dataset's
19-class learning map; a scan without a label file gets zero labels. A
scan's name is ``<seq>_<frame>``, which the submission writer splits again.
"""

from __future__ import annotations

import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset

SPLIT2SEQ = dict(
    train=[0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    val=[8],
    test=[11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
)


def map_labels(raw: np.ndarray, mapping: dict) -> np.ndarray:
    """`mapping` applied to each raw id, int32; an id the map lacks raises
    `KeyError` (the JAX package's `np.vectorize(mapping.__getitem__)`)."""
    keys = np.array(sorted(mapping), dtype=np.int64)
    values = np.array([mapping[k] for k in keys], dtype=np.int64)
    raw = np.asarray(raw).astype(np.int64).reshape(-1)
    pos = np.clip(np.searchsorted(keys, raw), 0, len(keys) - 1)
    missing = keys[pos] != raw
    if missing.any():
        raise KeyError(int(raw[missing][0]))
    return values[pos].astype(np.int32)


@DATASETS.register_module()
class SemanticKITTIDataset(DefaultDataset):
    def __init__(self, ignore_index=-1, **kwargs):
        self.learning_map = self.get_learning_map(ignore_index)
        self.learning_map_inv = self.get_learning_map_inv(ignore_index)
        super().__init__(ignore_index=ignore_index, **kwargs)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else self.split
        data_list = []
        for seq in [s for split in splits for s in SPLIT2SEQ[split]]:
            vel_dir = os.path.join(self.data_root, "dataset", "sequences", str(seq).zfill(2), "velodyne")
            if os.path.isdir(vel_dir):
                data_list += [os.path.join(vel_dir, f) for f in sorted(os.listdir(vel_dir))]
        return data_list

    def get_data(self, idx):
        data_path = self.data_list[idx % len(self.data_list)]
        scan = np.fromfile(data_path, dtype=np.float32).reshape(-1, 4)
        label_file = data_path.replace("velodyne", "labels").replace(".bin", ".label")
        if os.path.exists(label_file):
            raw = np.fromfile(label_file, dtype=np.uint32).reshape(-1)
            segment = map_labels(raw & 0xFFFF, self.learning_map)
        else:
            segment = np.zeros(scan.shape[0], dtype=np.int32)
        return dict(coord=scan[:, :3], strength=scan[:, -1].reshape([-1, 1]), segment=segment,
                    name=self.get_data_name(idx))

    def get_data_name(self, idx):
        dir_path, file_name = os.path.split(self.data_list[idx % len(self.data_list)])
        sequence_name = os.path.basename(os.path.dirname(dir_path))
        return f"{sequence_name}_{os.path.splitext(file_name)[0]}"

    @staticmethod
    def get_learning_map(ignore_index):
        """Raw SemanticKITTI ids -> the 19 learned classes (the dataset's
        published `semantic-kitti.yaml` learning map)."""
        return {
            0: ignore_index, 1: ignore_index, 10: 0, 11: 1, 13: 4, 15: 2, 16: 4,
            18: 3, 20: 4, 30: 5, 31: 6, 32: 7, 40: 8, 44: 9, 48: 10, 49: 11,
            50: 12, 51: 13, 52: ignore_index, 60: 8, 70: 14, 71: 15, 72: 16,
            80: 17, 81: 18, 99: ignore_index, 252: 0, 253: 6, 254: 5, 255: 7,
            256: 4, 257: 4, 258: 3, 259: 4,
        }

    @staticmethod
    def get_learning_map_inv(ignore_index):
        """The 19 learned classes -> raw ids (the submission's labels)."""
        return {
            ignore_index: ignore_index, 0: 10, 1: 11, 2: 15, 3: 18, 4: 20, 5: 30,
            6: 31, 7: 32, 8: 40, 9: 44, 10: 48, 11: 49, 12: 50, 13: 51, 14: 70,
            15: 71, 16: 72, 17: 80, 18: 81,
        }
