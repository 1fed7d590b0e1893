"""ScanNet v2, 20 classes (counterpart of `ScanNetDataset` in
`pointcept_tpu/datasets/scannet.py`; parity target: reference
`pointcept/datasets/scannet.py:28`): DefaultDataset over preprocessed .npy
scenes whose labels are `segment20.npy`. The data-efficient `lr_file` /
`la_file` benchmarks and ScanNet200 are not ported."""

from __future__ import annotations

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class ScanNetDataset(DefaultDataset):
    VALID_ASSETS = ["coord", "color", "normal", "segment20", "instance"]
    # ScanNet's label ids of the 20 classes (the benchmark's submission format)
    class2id = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])

    def __init__(self, lr_file=None, la_file=None, **kwargs):
        if lr_file is not None or la_file is not None:
            raise NotImplementedError("ScanNetDataset: lr_file / la_file are not ported")
        super().__init__(**kwargs)

    def load_assets(self, idx) -> dict:
        data_dict = super().load_assets(idx)
        if "segment20" in data_dict:
            data_dict["segment"] = data_dict.pop("segment20").reshape([-1]).astype(np.int32)
        return data_dict
