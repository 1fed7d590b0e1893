from .builder import DATASETS, build_dataset
from .defaults import ConcatDataset, DefaultDataset
from .loader import DataLoader
from .nuscenes import NuScenesDataset
from .s3dis import S3DISDataset
from .scannet import ScanNet200Dataset, ScanNetDataset, ScanNetPPDataset
from .semantic_kitti import SemanticKITTIDataset
from .structured3d import Structured3DDataset
from .synthetic import SyntheticSemSegDataset, scene_batch, synthesize_scene, synthetic_arrays
from .transform import TRANSFORMS, Compose
from .utils import point_collate_fn
from .variants import NuScenesColorNormalDataset, SemanticKITTIColorNormalDataset, WaymoColorNormalDataset
from .waymo import WaymoDataset

__all__ = ["DATASETS", "TRANSFORMS", "Compose", "ConcatDataset", "DataLoader", "DefaultDataset",
           "NuScenesColorNormalDataset", "NuScenesDataset", "S3DISDataset", "ScanNet200Dataset", "ScanNetDataset",
           "ScanNetPPDataset", "SemanticKITTIColorNormalDataset", "SemanticKITTIDataset", "Structured3DDataset",
           "SyntheticSemSegDataset", "WaymoColorNormalDataset", "WaymoDataset", "build_dataset",
           "point_collate_fn", "scene_batch", "synthesize_scene", "synthetic_arrays"]
