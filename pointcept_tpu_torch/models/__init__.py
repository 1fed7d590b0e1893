from .builder import MODELS, build_model
from . import default  # noqa: F401  (registers DefaultSegmentorV2)
from .point_transformer_v3 import PointTransformerV3  # noqa: F401  (registers PT-v3m1)

__all__ = ["MODELS", "build_model", "PointTransformerV3"]
