from .train import make_point_batch

__all__ = ["make_point_batch"]
