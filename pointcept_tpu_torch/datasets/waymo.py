"""Waymo Open Dataset semantic segmentation (counterpart of
`pointcept_tpu/datasets/waymo.py`; parity target: reference
`pointcept/datasets/waymo.py`).

Preprocessed frames: ``data_root/<split>/<segment>/<frame>/`` holding
``coord.npy`` (float32 [N, 3], both returns), ``strength.npy`` (intensity,
squashed by tanh) and, where labelled, ``segment.npy`` (1-22, 0 undefined;
shifted down by one so that undefined becomes -1). A list of splits reads
the first, as the JAX package does; `timestamp` is accepted and unused, as
there. A frame's name is ``<segment>_<frame>``.
"""

from __future__ import annotations

import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class WaymoDataset(DefaultDataset):
    def __init__(self, timestamp=(0,), **kwargs):
        self.timestamp = timestamp
        super().__init__(**kwargs)

    def get_data_list(self):
        split_dir = os.path.join(self.data_root, self.split if isinstance(self.split, str) else self.split[0])
        if not os.path.isdir(split_dir):
            return []
        data_list = []
        for seq in sorted(os.listdir(split_dir)):
            seq_dir = os.path.join(split_dir, seq)
            if os.path.isdir(seq_dir):
                data_list += [os.path.join(seq_dir, f) for f in sorted(os.listdir(seq_dir))]
        return data_list

    def get_data(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        data = dict(name=self.get_data_name(idx))
        for asset in os.listdir(path):
            if asset.endswith(".npy"):
                data[asset[: -len(".npy")]] = np.load(os.path.join(path, asset))
        data["coord"] = data["coord"].astype(np.float32)
        if "strength" in data:
            data["strength"] = np.tanh(data["strength"].reshape([-1, 1])).astype(np.float32)
        if "segment" in data:
            data["segment"] = data["segment"].reshape([-1]).astype(np.int32) - 1  # 0 (undefined) -> -1
        else:
            data["segment"] = np.full(data["coord"].shape[0], -1, dtype=np.int32)
        return data

    def get_data_name(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        return f"{os.path.basename(os.path.dirname(path))}_{os.path.basename(path)}"
