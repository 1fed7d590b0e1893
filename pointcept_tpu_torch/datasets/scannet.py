"""ScanNet v2 at 20 and 200 classes, and ScanNet++ (counterparts of
`pointcept_tpu/datasets/scannet.py`; parity targets: reference
`pointcept/datasets/scannet.py:28,109` and `scannetpp.py`): DefaultDataset
over preprocessed .npy scenes whose labels are `segment20.npy`,
`segment200.npy` or, for ScanNet++, `segment.npy` (one label a point).

The data-efficient benchmarks: `lr_file` (limited reconstructions) names
the train scenes, one a line, read from ``data_root/train``; `la_file`
(limited annotations) maps a scene's name to the indices of its labelled
points, and every other point's label becomes `ignore_index`, the indices
kept as ``sampled_index`` for `RandomDropout` and `GridSample`. An
`la_file` is a pickled dict, as the JAX package reads it (`np.save` of the
dict) or as the reference's `torch.save`.

ScanNet200 has no `class2id`: its submission needs the benchmark's 200 label
ids, which the repository does not hold (the tester raises)."""

from __future__ import annotations

import os.path as osp

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset


def read_scene_list(path: str) -> np.ndarray:
    """An `lr_file`'s scene names, one a line, as a 1-d array (also for a
    file of one line, which the JAX package reads as a 0-d array)."""
    return np.atleast_1d(np.loadtxt(path, dtype=str))


def read_label_index(path: str) -> dict:
    """An `la_file`'s dict of scene name -> labelled point indices."""
    with open(path, "rb") as f:
        magic = f.read(6)
    if magic == b"\x93NUMPY":
        return np.load(path, allow_pickle=True).item()
    import torch

    return {k: np.asarray(v) for k, v in torch.load(path, weights_only=False).items()}


@DATASETS.register_module()
class ScanNetDataset(DefaultDataset):
    VALID_ASSETS = ["coord", "color", "normal", "segment20", "instance"]
    label_asset = "segment20"
    # ScanNet's label ids of the 20 classes (the benchmark's submission format)
    class2id = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])

    def __init__(self, lr_file=None, la_file=None, **kwargs):
        self.lr = read_scene_list(lr_file) if lr_file is not None else None
        self.la = read_label_index(la_file) if la_file is not None else None
        super().__init__(**kwargs)

    def get_data_list(self):
        if self.lr is None:
            return super().get_data_list()
        return [osp.join(self.data_root, "train", name) for name in self.lr]

    def load_assets(self, idx) -> dict:
        data_dict = super().load_assets(idx)
        if self.label_asset in data_dict:
            data_dict["segment"] = data_dict.pop(self.label_asset).reshape([-1]).astype(np.int32)
        return data_dict

    def get_data(self, idx):
        data_dict = super().get_data(idx)
        if self.la:
            sampled_index = self.la[self.get_data_name(idx)]
            mask = np.ones_like(data_dict["segment"], dtype=bool)
            mask[sampled_index] = False
            data_dict["segment"][mask] = self.ignore_index
            data_dict["sampled_index"] = sampled_index
        return data_dict


@DATASETS.register_module()
class ScanNet200Dataset(ScanNetDataset):
    VALID_ASSETS = ["coord", "color", "normal", "segment200", "instance"]
    label_asset = "segment200"
    class2id = None


@DATASETS.register_module()
class ScanNetPPDataset(DefaultDataset):
    """ScanNet++ in the layout of the JAX package's preprocessing
    (`pointcept_tpu/datasets/preprocessing/scannetpp.py`): one label a point
    in a 1-d `segment.npy`. A `segment` of several columns (the top-k labels
    of a point, as the reference's preprocessing writes) is refused: read as
    one label a point, it would give k labels for each point."""

    VALID_ASSETS = ["coord", "color", "normal", "segment", "instance"]

    def load_assets(self, idx) -> dict:
        data_dict = super().load_assets(idx)
        seg = data_dict.get("segment")
        if seg is not None and seg.ndim > 1 and seg.shape[1] != 1:
            raise ValueError(f"ScanNetPPDataset: {data_dict['name']}/segment.npy has shape {seg.shape}; the "
                             f"layout read is one label a point ([N] or [N, 1]), not top-{seg.shape[1]} labels")
        return data_dict
