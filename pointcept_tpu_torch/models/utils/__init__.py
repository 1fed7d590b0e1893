from .structure import PointBatch

__all__ = ["PointBatch"]
