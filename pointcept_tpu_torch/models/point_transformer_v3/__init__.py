from .point_transformer_v3 import PointTransformerV3

__all__ = ["PointTransformerV3"]
