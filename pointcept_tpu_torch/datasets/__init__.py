from .builder import DATASETS, build_dataset
from .defaults import ConcatDataset, DefaultDataset
from .loader import DataLoader
from .s3dis import S3DISDataset
from .scannet import ScanNet200Dataset, ScanNetDataset, ScanNetPPDataset
from .structured3d import Structured3DDataset
from .synthetic import SyntheticSemSegDataset, scene_batch, synthesize_scene, synthetic_arrays
from .transform import TRANSFORMS, Compose
from .utils import point_collate_fn

__all__ = ["DATASETS", "TRANSFORMS", "Compose", "ConcatDataset", "DataLoader", "DefaultDataset",
           "S3DISDataset", "ScanNet200Dataset", "ScanNetDataset", "ScanNetPPDataset", "Structured3DDataset",
           "SyntheticSemSegDataset", "build_dataset", "point_collate_fn", "scene_batch",
           "synthesize_scene", "synthetic_arrays"]
