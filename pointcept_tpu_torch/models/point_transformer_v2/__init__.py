from .point_transformer_v2 import PointTransformerV2

__all__ = ["PointTransformerV2"]
