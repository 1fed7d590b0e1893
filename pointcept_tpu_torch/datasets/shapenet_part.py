"""ShapeNet-Part and ScanObjectNN (counterpart of
`pointcept_tpu/datasets/shapenet_part.py`; parity targets: reference
`pointcept/datasets/shapenet_part.py`, `scanobjectnn.py`).

ShapeNet-Part: 16 categories, 50 parts, the
`shapenetcore_partanno_segmentation_benchmark_v0_normal` layout
(``<synset>/<id>.txt`` rows x, y, z, nx, ny, nz, part;
``train_test_split/shuffled_{split}_file_list.json``;
``synsetoffset2category.txt``). ScanObjectNN: the h5 files of
``<data_root>/<variant>/`` (``data`` [S, N, 3], ``label`` [S]).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class ShapeNetPartDataset(DefaultDataset):
    """A shape's coord, normal, part ``segment`` and ``category`` [1] (its
    index in `categories`; 0 for a synset the category file does not
    name). `category2part` is the benchmark's part range of each category."""

    categories = [
        "Airplane", "Bag", "Cap", "Car", "Chair", "Earphone", "Guitar", "Knife",
        "Lamp", "Laptop", "Motorbike", "Mug", "Pistol", "Rocket", "Skateboard", "Table",
    ]
    category2part = {
        "Airplane": [0, 1, 2, 3], "Bag": [4, 5], "Cap": [6, 7], "Car": [8, 9, 10, 11],
        "Chair": [12, 13, 14, 15], "Earphone": [16, 17, 18], "Guitar": [19, 20, 21],
        "Knife": [22, 23], "Lamp": [24, 25, 26, 27], "Laptop": [28, 29],
        "Motorbike": [30, 31, 32, 33, 34, 35], "Mug": [36, 37], "Pistol": [38, 39, 40],
        "Rocket": [41, 42, 43], "Skateboard": [44, 45, 46], "Table": [47, 48, 49],
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.synset2category = {}
        cat_file = os.path.join(self.data_root, "synsetoffset2category.txt")
        if os.path.isfile(cat_file):
            with open(cat_file) as f:
                for line in f:
                    name, synset = line.strip().split()
                    self.synset2category[synset] = name

    def get_data_list(self):
        split_file = os.path.join(self.data_root, "train_test_split", f"shuffled_{self.split}_file_list.json")
        if not os.path.isfile(split_file):
            return []
        with open(split_file) as f:
            entries = json.load(f)
        return [os.path.join(self.data_root, *e.split("/")[1:]) + ".txt" for e in entries]

    def get_data(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        raw = np.loadtxt(path).astype(np.float32)
        synset = os.path.basename(os.path.dirname(path))
        category = self.synset2category.get(synset, synset)
        cat_idx = self.categories.index(category) if category in self.categories else 0
        return dict(coord=raw[:, :3], normal=raw[:, 3:6], segment=raw[:, 6].astype(np.int32),
                    category=np.array([cat_idx], np.int32), name=os.path.splitext(os.path.basename(path))[0],
                    split=self.split)

    def get_data_name(self, idx):
        return os.path.splitext(os.path.basename(self.data_list[idx % len(self.data_list)]))[0]


@DATASETS.register_module()
class ScanObjectNNDataset(DefaultDataset):
    """ScanObjectNN's ``training_objectdataset_augmentedrot_scale75.h5``
    (split ``train``) or ``test_...`` (any other split) of
    ``<data_root>/<variant>/``: each object's coord, ``category`` [1] and
    ``segment`` -1. The files carry no normals. Raises where `h5py` is not
    installed, naming it, and where the file is absent (the JAX package
    returns an empty list in both cases, and trains on nothing)."""

    def __init__(self, variant="main_split", **kwargs):
        self.variant = variant
        self._points = None
        self._labels = None
        super().__init__(**kwargs)

    def get_data_list(self):
        fname = ("training_objectdataset_augmentedrot_scale75.h5" if self.split == "train"
                 else "test_objectdataset_augmentedrot_scale75.h5")
        path = os.path.join(self.data_root, self.variant, fname)
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"{type(self).__name__}: reading {path} needs the h5py package, "
                              "which is not installed") from e
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{type(self).__name__}: no {path}")
        with h5py.File(path, "r") as f:
            self._points = np.asarray(f["data"]).astype(np.float32)
            self._labels = np.asarray(f["label"]).reshape(-1).astype(np.int32)
        return list(range(len(self._labels)))

    def get_data(self, idx):
        i = self.data_list[idx % len(self.data_list)]
        return dict(coord=self._points[i], segment=np.full(self._points[i].shape[0], -1, np.int32),
                    category=np.array([self._labels[i]], np.int32), name=f"{self.split}_{i}", split=self.split)

    def get_data_name(self, idx):
        return f"{self.split}_{self.data_list[idx % len(self.data_list)]}"
