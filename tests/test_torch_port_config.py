"""The port's config system against the JAX package's, on the CPU.

`pointcept_tpu_torch.utils.config` is the port's own copy of
`pointcept_tpu/utils/config.py`: every config file under `configs/` (outside
`_base_/`) must load into the same plain dict with either, and the dotted
`merge_from_dict` and the `--options` parser must agree. Exact equality: the
loader is pure Python."""

import argparse
from pathlib import Path

import pytest

from pointcept_tpu.utils.config import Config as JaxConfig
from pointcept_tpu.utils.config import DictAction as JaxDictAction
from pointcept_tpu_torch.engines import default_argument_parser, default_config_parser
from pointcept_tpu_torch.utils.config import Config, DictAction

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.py") if "_base_" not in p.parts)


def test_every_config_is_listed():
    assert len(CONFIGS) > 250


@pytest.mark.parametrize("path", CONFIGS)
def test_config_equals_jax(path):
    got = Config.fromfile(str(ROOT / path))._cfg_dict.to_dict()
    want = JaxConfig.fromfile(str(ROOT / path))._cfg_dict.to_dict()
    assert got == want


OPTIONS = {"model.backbone.enc_depths": (1, 1, 1, 1, 1), "data.train.data_root": "/tmp/scenes",
           "data.train.transform.1.dropout_ratio": 0.5, "batch_size": 2, "hooks.4.save_freq": 1,
           "optimizer.lr": 1e-3, "new_key.nested": [1, 2]}


def test_merge_from_dict_with_dotted_keys():
    path = str(ROOT / "configs/scannet/semseg-pt-v3m1-0-base.py")
    cfg, want = Config.fromfile(path), JaxConfig.fromfile(path)
    cfg.merge_from_dict(dict(OPTIONS))
    want.merge_from_dict(dict(OPTIONS))
    assert cfg._cfg_dict.to_dict() == want._cfg_dict.to_dict()
    assert cfg.model.backbone.enc_depths == (1, 1, 1, 1, 1)
    assert cfg.data.train.transform[1].dropout_ratio == 0.5
    assert cfg.data.train.transform[1].type == "RandomDropout"
    assert cfg.hooks[4].save_freq == 1 and cfg.hooks[4].type == "CheckpointSaver"
    assert cfg.data.val.data_root == "data/scannet"
    assert cfg.new_key.nested == [1, 2]


ARGV = ["--options", "save_path=/tmp/x", "epoch=2", "enable_amp=false", "weight=None", "lr=1e-3",
        "model.backbone.stride=2,2,2", "names=[a,b]", "pair=(1,[2,3])", "mode=random"]


def test_options_parser_equals_jax():
    got = default_argument_parser().parse_args(["--config-file", "x.py"] + ARGV).options
    parser = argparse.ArgumentParser()
    parser.add_argument("--options", nargs="+", action=JaxDictAction)
    want = parser.parse_args(ARGV).options
    assert got == want
    assert got["epoch"] == 2 and got["enable_amp"] is False and got["weight"] is None
    assert got["model.backbone.stride"] == (2, 2, 2) and got["pair"] == (1, [2, 3])
    assert DictAction._parse_iterable("[a,b]") == ["a", "b"]


def test_dump_round_trips(tmp_path):
    path = str(ROOT / "configs/synthetic/semseg-pt-v3m1-0-tiny.py")
    cfg = Config.fromfile(path)
    cfg.dump(str(tmp_path / "dumped.py"))
    assert Config.fromfile(str(tmp_path / "dumped.py"))._cfg_dict.to_dict() == cfg._cfg_dict.to_dict()


def test_config_parser_compresses_epochs(tmp_path):
    cfg = default_config_parser(str(ROOT / "configs/scannet/semseg-pt-v3m1-0-base.py"),
                                dict(save_path=str(tmp_path / "exp"), epoch=8, eval_epoch=2))
    assert cfg.data.train.loop == 4
    assert (tmp_path / "exp" / "model").is_dir() and (tmp_path / "exp" / "config.py").is_file()
    assert cfg.seed is not None
