"""The port's indoor datasets, their transforms and PolyLR against the JAX
package's, on the CPU.

ScanNet200, ScanNet++, S3DIS (a tuple of areas) and Structured3D (a list of
shard directories) on scenes this test writes in each dataset's layout:
each `get_data` dict bit for bit, and S3DIS's and ScanNet200's train
pipelines on the same seeds. ShufflePoint, RandomDropColor and
RandomDropNormal bit for bit, with both generators left in the same state.
PolyLR's lr at each step of two param groups against the JAX schedule times
the `param_dicts` multiplier. The ScanNet200 submission and a ScanNet++
`segment` of several columns, each beside the JAX package's behaviour."""

import copy
import random
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointcept_tpu.datasets import build_dataset as jax_build_dataset
from pointcept_tpu.datasets.transform import TRANSFORMS as JAX_TRANSFORMS
from pointcept_tpu.engines.test import SemSegTester as JaxSemSegTester
from pointcept_tpu.utils.config import Config as JaxConfig
from pointcept_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from pointcept_tpu_torch.datasets import TRANSFORMS, build_dataset, synthesize_scene
from pointcept_tpu_torch.engines import SemSegTester
from pointcept_tpu_torch.utils import build_optimizer, build_scheduler
from pointcept_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
S3DIS = str(ROOT / "configs/s3dis/semseg-spunet-v1m1-0-base.py")
SCANNET200 = str(ROOT / "configs/scannet200/semseg-pt-v3m1-0-base.py")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a test process: the suite runs in several such
    processes at once, and a thread per core in each makes their OpenMP
    regions contend (the reason of tests/test_torch_port_trainer.py's
    fixture of the same name)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def _write(d: Path, seed: int, n: int, labels: dict, normal: bool = True, color_dtype=np.uint8):
    """One scene directory: coord, color, (normal), instance and `labels`
    (asset name -> number of classes, or (classes, columns))."""
    d.mkdir(parents=True)
    s = synthesize_scene(seed, num_points=n, num_classes=20, extent=3.0)
    rng = np.random.RandomState(seed)
    np.save(d / "coord.npy", s["coord"])
    np.save(d / "color.npy", s["color"].astype(color_dtype))
    if normal:
        np.save(d / "normal.npy", s["normal"])
    np.save(d / "instance.npy", s["instance"].astype(np.int16))
    for name, classes in labels.items():
        shape = (n,) if isinstance(classes, int) else (n, classes[1])
        k = classes if isinstance(classes, int) else classes[0]
        np.save(d / f"{name}.npy", rng.randint(-1, k, shape).astype(np.int16))


def _layout(root: Path, kind: str) -> dict:
    """Scenes in `kind`'s layout under `root`; the dataset kwargs that read them."""
    if kind == "scannet200":
        for split, seeds in (("train", (0, 1)), ("val", (2,))):
            for seed in seeds:
                _write(root / split / f"scene{seed:04d}_00", seed, 2000, {"segment20": 20, "segment200": 200})
        return dict(type="ScanNet200Dataset", split="train")
    if kind == "scannetpp":
        for seed in (0, 1):
            _write(root / "train" / f"{seed:02x}c4b1ad05", seed, 2000, {"segment": 100})
        return dict(type="ScanNetPPDataset", split="train")
    if kind == "s3dis":
        for area, rooms in (("Area_1", ("office_1", "hallway_2")), ("Area_2", ("conferenceRoom_1",)),
                            ("Area_5", ("office_3",))):
            for i, room in enumerate(rooms):
                _write(root / area / room, 10 * int(area[-1]) + i, 2500, {"segment": 13}, color_dtype=np.float32)
        return dict(type="S3DISDataset", split=("Area_2", "Area_1"))
    assert kind == "structured3d"
    for shard, seeds in (("train_0", (0, 1)), ("train_1", (2,))):
        for seed in seeds:
            _write(root / shard / f"scene_{seed:05d}_room_{seed + 40}", seed, 1500, {"segment": 25})
    return dict(type="Structured3DDataset", split=["train_1", "train_0"])


@pytest.mark.parametrize("kind", ["scannet200", "scannetpp", "s3dis", "structured3d"])
def test_get_data_equals_jax(tmp_path, kind):
    """Each dataset's scene list and `get_data` dicts, bit for bit (S3DIS
    reads its tuple of areas and Structured3D its list of shards in the
    order given)."""
    cfg = dict(_layout(tmp_path, kind), data_root=str(tmp_path))
    ds, jds = build_dataset(dict(cfg)), jax_build_dataset(dict(cfg))
    assert ds.data_list == jds.data_list and len(ds) > 1
    for idx in range(len(ds)):
        got, want = ds.get_data(idx), jds.get_data(idx)
        _assert_same(got, want)
        assert got["segment"].shape == (got["coord"].shape[0],)
    if kind == "s3dis":
        assert [Path(p).parent.name for p in ds.data_list] == ["Area_2", "Area_1", "Area_1"]
    if kind == "structured3d":
        assert [Path(p).parent.name for p in ds.data_list] == ["train_1", "train_0", "train_0"]
    if kind == "scannet200":
        seg200 = np.load(tmp_path / "train" / "scene0000_00" / "segment200.npy")
        np.testing.assert_array_equal(ds.get_data(0)["segment"], seg200.astype(np.int32))
        assert seg200.max() >= 20


@pytest.mark.parametrize("kind,path", [("s3dis", S3DIS), ("scannet200", SCANNET200)])
@pytest.mark.parametrize("split", ["train", "val"])
def test_config_pipeline_equals_jax(tmp_path, kind, path, split):
    """The configs' own pipelines on the same seeds: S3DIS's (ShufflePoint,
    GridSample at 4 cm over the tuple of areas) and ScanNet200's."""
    _layout(tmp_path, kind)
    options = {"data.train.data_root": str(tmp_path), "data.val.data_root": str(tmp_path)}
    got_cfg, want_cfg = Config.fromfile(path), JaxConfig.fromfile(path)
    got_cfg.merge_from_dict(options)
    want_cfg.merge_from_dict(options)
    ds, jds = build_dataset(dict(got_cfg.data[split])), jax_build_dataset(dict(want_cfg.data[split]))
    assert len(ds) == len(jds) > 0
    for idx in range(min(len(ds), 2)):
        for seed in (idx, 100 + idx):
            np.random.seed(seed)
            random.seed(seed)
            got = ds[idx]
            np.random.seed(seed)
            random.seed(seed)
            _assert_same(got, jds[idx])
            assert got["feat"].shape[1] == 6


def _scene(seed=0, n=3000):
    data = synthesize_scene(seed, num_points=n, num_classes=13, extent=3.0)
    data["color"] = data["color"].astype(np.float32)
    return data


def _run(registry, cfg, data, seed):
    np.random.seed(seed)
    random.seed(seed)
    out = registry.build(dict(cfg))(copy.deepcopy(data))
    return out, np.random.get_state()[1].copy(), np.random.get_state()[2], random.getstate()


@pytest.mark.parametrize("cfg", [dict(type="ShufflePoint"),
                                 dict(type="RandomDropColor", drop_ratio=0.2, drop_application_ratio=0.5),
                                 dict(type="RandomDropNormal", drop_ratio=0.2, drop_application_ratio=0.5),
                                 dict(type="RandomDropColor", drop_ratio=0.6, drop_application_ratio=1.0),
                                 dict(type="RandomDropNormal", drop_ratio=0.6, drop_application_ratio=0.0)],
                         ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_transform_equals_jax(cfg):
    """Bit for bit on seeds that take both branches of the application draw
    (`random.random()`), both generators left in the same state; also on a
    scene without color and normal."""
    applied = set()
    for seed in range(6):
        data = _scene(seed)
        got, *got_state = _run(TRANSFORMS, cfg, data, seed)
        want, *want_state = _run(JAX_TRANSFORMS, cfg, data, seed)
        _assert_same(got, want)
        np.testing.assert_array_equal(got_state[0], want_state[0])
        assert got_state[1:] == want_state[1:]
        key = {"RandomDropColor": "color", "RandomDropNormal": "normal"}.get(cfg["type"], "coord")
        applied.add(not np.array_equal(got[key], data[key]))
    if cfg.get("drop_application_ratio", 1.0) not in (0.0, 1.0):
        assert applied == {True, False}
    missing = {k: v for k, v in _scene(0).items() if k not in ("color", "normal")}
    _assert_same(_run(TRANSFORMS, cfg, missing, 0)[0], _run(JAX_TRANSFORMS, cfg, missing, 0)[0])


def test_poly_lr_equals_jax():
    """PolyLR over 60 steps, two param groups (the base lr 0.1 and a `block`
    group at 0.01, as `param_dicts` makes them): each step's lr of the base
    group is the JAX schedule's bit for bit; the block group's equals the
    JAX schedule times the group's multiplier (0.01 / 0.1) within 1e-12
    relative, the two products rounding apart in the last bit."""
    total = 60
    model = torch.nn.ModuleDict(dict(block=torch.nn.Linear(2, 2), head=torch.nn.Linear(2, 2)))
    optimizer = build_optimizer(dict(type="SGD", lr=0.1, momentum=0.9), model, [dict(keyword="block", lr=0.01)])
    scheduler = build_scheduler(dict(type="PolyLR", base_lr=0.1), optimizer, total_steps=total)
    schedule = jax_build_scheduler(dict(type="PolyLR", base_lr=0.1), total)
    for step in range(total):
        want = schedule(step)
        assert optimizer.param_groups[0]["lr"] == want, step
        assert optimizer.param_groups[1]["lr"] == pytest.approx(want * (0.01 / 0.1), rel=1e-12), step
        optimizer.step()
        scheduler.step()
    assert 0 < optimizer.param_groups[0]["lr"] < 0.1 * 0.05
    power = build_scheduler(dict(type="PolyLR", power=2.0), optimizer, total_steps=total)
    assert power.get_last_lr()[1] == 0.01 and jax_build_scheduler(dict(type="PolyLR", power=2.0), total).power == 2.0


def _tester(ds_type, dataset=None):
    return SimpleNamespace(cfg=Config(dict(data=dict(test=dict(type=ds_type)))), test_dataset=dataset)


def test_scannet200_submission_raises_naming_the_ids(tmp_path):
    """The port refuses the ScanNet200 submission and names the list it
    lacks (the benchmark's 200 label ids); ScanNet++'s writes ``_pred.npy``
    as the JAX writer does."""
    pred = np.array([0, 5, 150, 199])
    with pytest.raises(NotImplementedError, match="200 label ids"):
        SemSegTester.write_submission(_tester("ScanNet200Dataset"), str(tmp_path), "scene0000_00", pred)
    for writer, sub in ((SemSegTester, "port"), (JaxSemSegTester, "jax")):
        (tmp_path / sub).mkdir()
        writer.write_submission(_tester("ScanNetPPDataset"), str(tmp_path / sub), "0a5c013435", pred)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "0a5c013435_pred.npy"),
                                  np.load(tmp_path / "jax" / "0a5c013435_pred.npy"))


def test_jax_scannet200_submission_indexes_scannet_ids(tmp_path):
    """The JAX writer maps ScanNet200's preds through ScanNet's 20 ids: the
    first pred above 19 raises an IndexError."""
    cfg = JaxConfig(dict(data=dict(test=dict(type="ScanNet200Dataset"))))
    JaxSemSegTester.write_submission(SimpleNamespace(cfg=cfg), str(tmp_path), "low", np.array([0, 19]))
    with pytest.raises(IndexError):
        JaxSemSegTester.write_submission(SimpleNamespace(cfg=cfg), str(tmp_path), "high", np.array([0, 150]))


def test_scannetpp_multi_column_segment(tmp_path):
    """A `segment` of top-3 labels (the reference preprocessing's layout):
    the JAX dataset flattens it to 3N labels for N points, the port raises
    and names the layout it reads."""
    _write(tmp_path / "train" / "0a5c013435", 0, 800, {"segment": (100, 3)})
    cfg = dict(type="ScanNetPPDataset", split="train", data_root=str(tmp_path))
    want = jax_build_dataset(dict(cfg)).get_data(0)
    assert want["segment"].shape == (3 * want["coord"].shape[0],)
    with pytest.raises(ValueError, match="one label a point"):
        build_dataset(dict(cfg)).get_data(0)


def test_scannet200_la_file_masks_its_labels(tmp_path):
    """An `la_file` on ScanNet200: the port masks the 200-class labels
    outside each scene's labelled points, as the reference masks
    ``segment200``; the JAX dataset masks its placeholder labels before
    ``segment200`` replaces them, so every label stays."""
    _layout(tmp_path, "scannet200")
    la = {name: np.array([3, 50, 700]) for name in ("scene0000_00", "scene0001_00")}
    with open(tmp_path / "la.npy", "wb") as f:
        np.save(f, la)
    cfg = dict(type="ScanNet200Dataset", split="train", data_root=str(tmp_path), la_file=str(tmp_path / "la.npy"))
    got, want = build_dataset(dict(cfg)).get_data(0), jax_build_dataset(dict(cfg)).get_data(0)
    seg200 = np.load(tmp_path / "train" / "scene0000_00" / "segment200.npy").astype(np.int32)
    keep = np.full(seg200.shape, -1, np.int32)
    keep[la["scene0000_00"]] = seg200[la["scene0000_00"]]
    np.testing.assert_array_equal(got["segment"], keep)
    np.testing.assert_array_equal(want["segment"], seg200)
