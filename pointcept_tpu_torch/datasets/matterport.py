"""Matterport3D regions and AEO scenes (counterparts of `MatterportDataset`
and `AEODataset` in `pointcept_tpu/datasets/scannet_pair.py`; reference
`pointcept/datasets/matterport3d.py`, `aeo.py`): preprocessed .npy scenes
under ``data_root/<split>/<scene>/`` (coord, color, normal, segment, ...),
read as `DefaultDataset` reads them."""

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class MatterportDataset(DefaultDataset):
    pass


@DATASETS.register_module()
class AEODataset(DefaultDataset):
    pass
