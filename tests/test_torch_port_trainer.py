"""The port's config-driven trainer against the JAX package's, on the CPU.

The JAX `Trainer` runs on a one-device mesh (a subclass here: the tests'
conftest gives JAX 8 virtual CPU devices) on `semseg-pt-v3m1-0-tiny.py` with
AMP, drop path, order shuffles and host geometry off, batch 2 at capacity
4,096. Its initial weights go into the port's trainer (`params_from_jax`).
Both read the same batches (the loaders seed alike, the transforms are bit
for bit the same), so the per-step losses of one epoch must agree within
2e-2 relative (the tolerance of tests/test_torch_port_train.py), and the
evaluator's per-class sums on the same weights within 1% of the valid
points, mIoU within 1e-2. Then the port alone: save and resume give the bits
of the straight run, weight-only loads, SpUNet's tiny config, and the entry
points refusing to run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pointcept_tpu.engines.defaults import default_config_parser as jax_config_parser
from pointcept_tpu.engines.defaults import default_setup as jax_setup
from pointcept_tpu.engines.train import Trainer as JaxTrainer
from pointcept_tpu_torch.engines import Trainer, default_config_parser, default_setup, main_worker
from pointcept_tpu_torch.engines.hooks import CheckpointLoader, SemSegEvaluator
from pointcept_tpu_torch.models.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs/synthetic/semseg-pt-v3m1-0-tiny.py")
SPUNET_TINY = str(ROOT / "configs/synthetic/semseg-spunet-v1m1-0-tiny.py")
# sorted_layout off: the JAX train step of the sorted layout with unshuffled
# orders and on-device geometry fails (a float0 cotangent of coord reaches
# the packed gather of its final reorder, `ops/permute.py:46`)
OPTIONS = {"enable_amp": False, "model.backbone.drop_path": 0.0, "model.backbone.shuffle_orders": False,
           "model.backbone.sorted_layout": False, "host_geometry": False, "batch_size": 2,
           "point_capacity": 4096, "point_capacity_val": 4096, "num_worker": 0, "epoch": 1, "eval_epoch": 1,
           "seed": 0, "data.train.num_scenes": 6, "data.train.num_points": 3000, "data.val.num_scenes": 2,
           "data.val.num_points": 3000}
LOSS_RTOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The runs here are small: two torch threads run them as fast as all
    cores do alone, and keep them fast beside the other test processes
    (with a thread per core in every process, the AMP runs' OpenMP regions
    slowed some tests 40x)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class OneDeviceJaxTrainer(JaxTrainer):
    """The JAX trainer on a one-device mesh, recording each step's loss."""

    losses = None

    def build_mesh(self):
        return Mesh(np.array(jax.devices()[:1]), ("data",))

    @property
    def num_devices(self):
        return 1

    @property
    def num_local_devices(self):
        return 1

    def run_step(self):
        super().run_step()
        self.losses.append(float(self.comm_info["metrics"]["loss"]))


def _jax_eval_sums(trainer):
    inter, union, target = 0, 0, 0
    for batch in trainer.val_loader:
        res = trainer.eval_step(trainer.state, trainer._to_global(batch))
        inter, union = inter + np.asarray(res["intersection"]), union + np.asarray(res["union"])
        target = target + np.asarray(res["target"])
    return dict(intersection=inter, union=union, target=target,
                mIoU=float(np.mean(inter / (union + 1e-10))))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX trainer for the module (its train step compiles once): its
    initial weights, the eval sums on them, and one epoch's losses."""
    cfg = jax_setup(jax_config_parser(TINY, dict(OPTIONS, save_path=str(tmp_path_factory.mktemp("jax")))))
    cfg.hooks = []
    trainer = OneDeviceJaxTrainer(cfg)
    trainer.losses = []
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    weights = params_from_jax(tree(trainer.state.params), tree(trainer.state.batch_stats))
    sums = _jax_eval_sums(trainer)
    trainer.train()
    return dict(weights=weights, eval=sums, losses=list(trainer.losses))


def _port_trainer(tmp_path, options=OPTIONS, path=TINY, **extra):
    cfg = default_setup(default_config_parser(path, dict(options, save_path=str(tmp_path), **extra)))
    return Trainer(cfg, device="cpu")


def _losses(save_path):
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        return [(row["epoch"], row["loss"]) for row in map(json.loads, f)]


def test_trainer_losses_match_jax(jax_run, tmp_path):
    trainer = _port_trainer(tmp_path)
    trainer.model.load_state_dict(jax_run["weights"], strict=True)
    trainer.train()
    got = [loss for _, loss in _losses(tmp_path)]
    want = jax_run["losses"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert (tmp_path / "model" / "model_last.pth").is_file()


def test_evaluator_matches_jax(jax_run, tmp_path):
    trainer = _port_trainer(tmp_path)
    trainer.model.load_state_dict(jax_run["weights"], strict=True)
    hook = SemSegEvaluator()
    hook.trainer = trainer
    got, want = hook.eval(), jax_run["eval"]
    np.testing.assert_array_equal(got["target"], want["target"])
    valid = want["target"].sum()
    assert valid > 1000
    for key in ("intersection", "union"):
        assert np.abs(got[key] - want[key]).max() <= 0.01 * valid, key
    assert abs(got["mIoU"] - want["mIoU"]) < 1e-2
    assert trainer.comm_info["current_metric_value"] == got["mIoU"]


# the port alone, with the tiny config's own randomness: Mix3D, drop path,
# shuffled orders, AMP
RESUME_OPTIONS = dict(OPTIONS, enable_amp=True, **{"model.backbone.drop_path": 0.1,
                                                   "model.backbone.shuffle_orders": True,
                                                   "data.train.num_scenes": 4, "epoch": 2, "eval_epoch": 2,
                                                   "hooks.4.save_freq": 1})


def test_resume_equals_straight_run(tmp_path):
    """Two epochs straight against one epoch, a save, and the second epoch
    resumed from `epoch_1.pth`: the same losses and parameters, bit for bit."""
    straight = main_worker(default_config_parser(TINY, dict(RESUME_OPTIONS, save_path=str(tmp_path / "a"))),
                           device="cpu")
    model_dir = tmp_path / "a" / "model"
    assert {p.name for p in model_dir.iterdir()} >= {"model_last.pth", "model_best.pth", "epoch_1.pth",
                                                      "epoch_2.pth"}
    resumed = main_worker(default_config_parser(TINY, dict(RESUME_OPTIONS, save_path=str(tmp_path / "b"),
                                                           weight=str(model_dir / "epoch_1.pth"),
                                                           resume=True)), device="cpu")
    assert resumed.start_epoch == 1
    first = _losses(tmp_path / "a")
    assert [e for e, _ in first] == [1, 1, 2, 2]
    assert _losses(tmp_path / "b") == [r for r in first if r[0] == 2]
    for (name, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert resumed.best_metric_value >= straight.comm_info["eval_result"]["mIoU"] - 1e-12


def test_weight_only_load_with_keywords_and_module_prefix(tmp_path):
    source = _port_trainer(tmp_path / "src")
    state = {f"module.{k.replace('backbone.', 'encoder.')}": v.clone() + 1 for k, v in
             source.model.state_dict().items()}
    torch.save(dict(state_dict=state, epoch=3), tmp_path / "renamed.pth")
    torch.save({k[len("module."):]: v for k, v in state.items()}, tmp_path / "bare.pth")
    for name, keywords in (("renamed.pth", "encoder."), ("bare.pth", "encoder.")):
        trainer = _port_trainer(tmp_path / f"run_{name}", weight=str(tmp_path / name))
        hook = CheckpointLoader(keywords=keywords, replacement="backbone.", strict=True)
        hook.trainer = trainer
        hook.before_train()
        assert trainer.start_epoch == 0  # weights only: no resume
        for k, v in trainer.model.state_dict().items():
            torch.testing.assert_close(v, source.model.state_dict()[k] + 1, rtol=0, atol=0)


def test_val_loader_raises_where_a_batch_overflows(tmp_path):
    """The train loader subsamples a batch above `point_capacity`; the val
    loader keeps every point, so a scene above `point_capacity_val` raises
    instead of being evaluated on a sample."""
    trainer = _port_trainer(tmp_path, point_capacity=1024, point_capacity_val=1024)
    batch = next(iter(trainer.train_loader))
    assert int((batch["batch"] >= 0).sum()) == 1024
    with pytest.raises(ValueError, match="> capacity 1024"):
        next(iter(trainer.val_loader))


def test_spunet_tiny_config_trains_one_epoch(tmp_path):
    trainer = main_worker(default_config_parser(SPUNET_TINY, dict(
        save_path=str(tmp_path), num_worker=0, batch_size=2, point_capacity=4096, point_capacity_val=4096,
        **{"data.train.num_scenes": 4, "data.train.num_points": 3000, "data.val.num_scenes": 2,
           "data.val.num_points": 3000})), device="cpu")
    losses = [loss for _, loss in _losses(tmp_path)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert np.isfinite(trainer.comm_info["eval_result"]["mIoU"])
    assert (tmp_path / "model" / "model_last.pth").is_file()


def test_trainer_and_cli_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run on it")
    cfg = default_setup(default_config_parser(TINY, dict(OPTIONS, save_path=str(tmp_path / "a"))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    out = subprocess.run([sys.executable, str(ROOT / "tools/torch_port_train.py"), "--config-file", TINY,
                          "--options", f"save_path={tmp_path / 'b'}", "num_worker=0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


@pytest.mark.parametrize("option", [dict(enable_wandb=True), dict(grad_accum_steps=2),
                                    {"optimizer.type": "Lamb"}, {"scheduler.type": "MultiStepWithWarmupLR"}])
def test_unported_options_raise_at_build(tmp_path, option):
    with pytest.raises((NotImplementedError, KeyError)):
        _port_trainer(tmp_path, **option)


def test_checkpoint_saver_links_best_and_epoch_files(tmp_path):
    """`model_best.pth` and `epoch_{n}.pth` are hard links of the
    `model_last.pth` they were made from: a later epoch's `model_last.pth`
    replaces its own file and leaves them holding their epoch."""
    from types import SimpleNamespace

    from pointcept_tpu_torch.engines.hooks import CheckpointSaver
    from pointcept_tpu_torch.utils.config import Config
    from pointcept_tpu_torch.utils.logger import get_root_logger

    model = torch.nn.Linear(2, 2)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    trainer = SimpleNamespace(model=model, optimizer=optimizer, cfg=Config(dict(save_path=str(tmp_path))),
                              scheduler=torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: 1.0), epoch=0,
                              best_metric_value=-np.inf, logger=get_root_logger(), comm_info={})
    saver = CheckpointSaver(save_freq=1)
    saver.trainer = trainer
    model_dir = tmp_path / "model"
    for epoch, metric in ((0, 0.5), (1, 0.1)):
        trainer.epoch = epoch
        trainer.comm_info["current_metric_value"] = metric
        with torch.no_grad():
            model.weight.fill_(float(epoch))
        saver.after_epoch()
    load = lambda name: torch.load(model_dir / name, weights_only=False)  # noqa: E731
    assert load("model_last.pth")["epoch"] == 2 and load("epoch_2.pth")["epoch"] == 2
    assert load("model_best.pth")["epoch"] == 1 and load("epoch_1.pth")["epoch"] == 1
    assert float(load("model_best.pth")["state_dict"]["weight"][0, 0]) == 0.0
    assert os.path.samefile(model_dir / "model_best.pth", model_dir / "epoch_1.pth")
    assert os.path.samefile(model_dir / "model_last.pth", model_dir / "epoch_2.pth")
    assert sorted(os.listdir(model_dir)) == ["epoch_1.pth", "epoch_2.pth", "model_best.pth", "model_last.pth"]
