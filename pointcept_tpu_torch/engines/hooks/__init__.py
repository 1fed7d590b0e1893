from .builder import HOOKS, build_hooks
from .default import HookBase
from .evaluator import SemSegEvaluator
from .misc import CheckpointLoader, CheckpointSaver, InformationWriter, IterationTimer

__all__ = ["HOOKS", "CheckpointLoader", "CheckpointSaver", "HookBase", "InformationWriter", "IterationTimer",
           "SemSegEvaluator", "build_hooks"]
