from .builder import DATASETS, build_dataset
from .defaults import ConcatDataset, DefaultDataset
from .loader import DataLoader
from .matterport import AEODataset, MatterportDataset
from .modelnet import ModelNetDataset
from .nuscenes import NuScenesDataset
from .partnete import PartNetEDataset
from .s3dis import S3DISDataset
from .scannet import ScanNet200Dataset, ScanNetDataset, ScanNetPPDataset
from .semantic_kitti import SemanticKITTIDataset
from .shapenet_part import ScanObjectNNDataset, ShapeNetPartDataset
from .structured3d import Structured3DDataset
from .synthetic import SyntheticClsDataset, SyntheticSemSegDataset, scene_batch, synthesize_scene, synthetic_arrays
from .transform import TRANSFORMS, Compose
from .utils import point_collate_fn
from .variants import (NuScenesColorNormalDataset, ScanObjectNNHardestDataset, SemanticKITTIColorNormalDataset,
                       WaymoColorNormalDataset)
from .waymo import WaymoDataset

__all__ = ["DATASETS", "TRANSFORMS", "AEODataset", "Compose", "ConcatDataset", "DataLoader", "DefaultDataset",
           "MatterportDataset", "ModelNetDataset", "NuScenesColorNormalDataset", "NuScenesDataset", "PartNetEDataset", "S3DISDataset",
           "ScanNet200Dataset", "ScanNetDataset", "ScanNetPPDataset", "ScanObjectNNDataset",
           "ScanObjectNNHardestDataset", "SemanticKITTIColorNormalDataset", "SemanticKITTIDataset",
           "ShapeNetPartDataset", "Structured3DDataset", "SyntheticClsDataset", "SyntheticSemSegDataset", "WaymoColorNormalDataset", "WaymoDataset", "build_dataset",
           "point_collate_fn", "scene_batch", "synthesize_scene", "synthetic_arrays"]
