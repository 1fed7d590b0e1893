from .builder import LOSSES, build_criteria
from . import lovasz, misc  # noqa: F401  (register CrossEntropyLoss, LovaszLoss)

__all__ = ["LOSSES", "build_criteria"]
