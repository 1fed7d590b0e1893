from .synthetic import scene_batch, synthesize_scene, synthetic_arrays
from .transform import TRANSFORMS, Compose
from .utils import point_collate_fn

__all__ = ["TRANSFORMS", "Compose", "point_collate_fn", "scene_batch", "synthesize_scene", "synthetic_arrays"]
