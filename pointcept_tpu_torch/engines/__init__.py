from .train import build_train_step, make_point_batch

__all__ = ["build_train_step", "make_point_batch"]
