"""Structured3D (counterpart of `pointcept_tpu/datasets/structured3d.py`;
parity target: reference `pointcept/datasets/structure3d.py`): preprocessed
.npy rooms under ``data_root/<split>/<room>/``; the split is a directory or
a list of shard directories, read in order by `DefaultDataset`."""

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class Structured3DDataset(DefaultDataset):
    pass
