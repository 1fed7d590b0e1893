from .builder import HOOKS, build_hooks
from .default import HookBase
from .evaluator import ClsEvaluator, InsSegEvaluator, SemSegEvaluator
from .misc import (CheckpointLoader, CheckpointSaver, InformationWriter, IterationTimer, SonataHook,
                   WeightDecaySchedular)

__all__ = ["HOOKS", "CheckpointLoader", "CheckpointSaver", "ClsEvaluator", "HookBase", "InformationWriter", "InsSegEvaluator",
           "IterationTimer", "SemSegEvaluator", "SonataHook", "WeightDecaySchedular", "build_hooks"]
