"""The outdoor datasets' ColorNormal variants (counterparts of
`pointcept_tpu/datasets/variants.py`; parity targets: reference
`semantic_kitti.py`, `nuscenes.py`, `waymo.py`): the same scans with zero
``color`` and ``normal`` fields, so that indoor-style pipelines that
collect them run on lidar data; and ScanObjectNN's hardest variant."""

import numpy as np

from .builder import DATASETS
from .nuscenes import NuScenesDataset
from .semantic_kitti import SemanticKITTIDataset
from .shapenet_part import ScanObjectNNDataset
from .waymo import WaymoDataset


class _ColorNormal:
    def get_data(self, idx):
        data_dict = super().get_data(idx)
        data_dict["color"] = np.zeros_like(data_dict["coord"])
        data_dict["normal"] = np.zeros_like(data_dict["coord"])
        return data_dict


@DATASETS.register_module()
class SemanticKITTIColorNormalDataset(_ColorNormal, SemanticKITTIDataset):
    pass


@DATASETS.register_module()
class NuScenesColorNormalDataset(_ColorNormal, NuScenesDataset):
    pass


@DATASETS.register_module()
class WaymoColorNormalDataset(_ColorNormal, WaymoDataset):
    pass


@DATASETS.register_module()
class ScanObjectNNHardestDataset(ScanObjectNNDataset):
    """The augmentedrot_scale75 h5 files (PB_T50_RS), which the base class
    already reads."""
