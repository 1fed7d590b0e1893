from .point_group import PointGroup, PointGroupV1M2

__all__ = ["PointGroup", "PointGroupV1M2"]
