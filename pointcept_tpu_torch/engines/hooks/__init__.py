from .builder import HOOKS, build_hooks
from .default import HookBase
from .evaluator import ClsEvaluator, InsSegEvaluator, PartNetEPartSegEvaluator, SemSegEvaluator, ShapeNetPartSegEvaluator
from .misc import (CheckpointLoader, CheckpointSaver, InformationWriter, IterationTimer, PreciseEvaluator,
                   RuntimeProfilerV2, SonataHook, WeightDecaySchedular)

__all__ = ["HOOKS", "CheckpointLoader", "CheckpointSaver", "ClsEvaluator", "HookBase", "InformationWriter",
           "InsSegEvaluator", "IterationTimer", "PartNetEPartSegEvaluator", "PreciseEvaluator", "RuntimeProfilerV2",
           "SemSegEvaluator", "ShapeNetPartSegEvaluator", "SonataHook", "WeightDecaySchedular", "build_hooks"]
