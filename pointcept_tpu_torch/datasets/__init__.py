from .builder import DATASETS, build_dataset
from .defaults import ConcatDataset, DefaultDataset
from .loader import DataLoader
from .scannet import ScanNetDataset
from .synthetic import SyntheticSemSegDataset, scene_batch, synthesize_scene, synthetic_arrays
from .transform import TRANSFORMS, Compose
from .utils import point_collate_fn

__all__ = ["DATASETS", "TRANSFORMS", "Compose", "ConcatDataset", "DataLoader", "DefaultDataset",
           "ScanNetDataset", "SyntheticSemSegDataset", "build_dataset", "point_collate_fn", "scene_batch",
           "synthesize_scene", "synthetic_arrays"]
