"""Argument parsing, config resolution and per-process setup (counterpart of
`pointcept_tpu/engines/defaults.py`; parity target: reference
`pointcept/engines/defaults.py:62-151`)."""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os

from ..utils import comm
from ..utils.config import Config, DictAction
from ..utils.env import get_random_seed, set_seed


def default_argument_parser(epilog=None):
    parser = argparse.ArgumentParser(
        epilog=epilog or "Examples: python tools/torch_port_train.py --config-file "
        "configs/scannet/semseg-pt-v3m1-0-base.py --options save_path=exp/debug",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--config-file", default="", metavar="FILE", help="path to config file")
    parser.add_argument("--options", nargs="+", action=DictAction,
                        help="custom options, e.g. save_path=exp/debug batch_size=8")
    return parser


def default_config_parser(file_path: str, options):
    """Load a config (a path, or the ``dataset-name`` shorthand), merge the
    options, derive the epoch compression ``data.train.loop = epoch //
    eval_epoch``, create ``save_path/model`` and dump the config there
    unless resuming."""
    if os.path.isfile(file_path):
        cfg = Config.fromfile(file_path)
    else:
        sep = file_path.find("-")
        cfg = Config.fromfile(os.path.join(file_path[:sep], file_path[sep + 1 :]))
    if options is not None:
        cfg.merge_from_dict(options)
    if cfg.get("seed", None) is None:
        cfg.seed = get_random_seed()
    cfg.data.train.loop = cfg.epoch // cfg.eval_epoch
    os.makedirs(os.path.join(cfg.save_path, "model"), exist_ok=True)
    if not cfg.get("resume", False):
        cfg.dump(os.path.join(cfg.save_path, "config.py"))
    return cfg


def default_setup(cfg):
    """Per-process setup: batch sizes per process, the shared seed (weights
    and the step's device randomness) and the per-rank seed ``seed *
    world_size + rank`` (augmentation), which seeds python and numpy."""
    world_size = comm.get_world_size()
    cfg.num_worker = cfg.get("num_worker", mp.cpu_count() // 2)
    cfg.num_worker_per_gpu = cfg.num_worker // world_size
    assert cfg.batch_size % world_size == 0, "batch_size must divide by the world size"
    assert cfg.batch_size_val is None or cfg.batch_size_val % world_size == 0
    cfg.batch_size_per_gpu = cfg.batch_size // world_size
    cfg.batch_size_val_per_gpu = cfg.batch_size_val // world_size if cfg.batch_size_val is not None else 1
    cfg.batch_size_test_per_gpu = (cfg.batch_size_test // world_size
                                   if cfg.get("batch_size_test", None) is not None else 1)
    seed = cfg.seed if cfg.get("seed") is not None else get_random_seed()
    cfg.shared_seed = seed
    seed = seed * world_size + comm.get_rank()
    set_seed(seed)
    cfg.seed = seed
    return cfg
