from .defaults import default_argument_parser, default_config_parser, default_setup
from .test import TESTERS, InsSegTester, SemSegTester, TesterBase
from .train import (TRAINERS, MultiDatasetTrainer, Trainer, TrainerBase, build_train_step, main_worker, make_inputs,
                    make_point_batch, make_view_inputs)

__all__ = ["TESTERS", "TRAINERS", "InsSegTester", "MultiDatasetTrainer", "SemSegTester", "TesterBase", "Trainer",
           "TrainerBase", "build_train_step", "default_argument_parser", "default_config_parser", "default_setup", "main_worker",
           "make_inputs", "make_point_batch", "make_view_inputs"]
