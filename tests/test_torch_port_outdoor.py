"""The port's outdoor slice against the JAX package, on the CPU.

The key fold: a two-scene batch with one scene wider than ``2**depth``
cells sorts, inverts and looks up its key triples as the JAX package's
lexicographic sort does, at depths 11 and 12 and in all four orders. The
depth a batch serializes at: the config's while the grid fits it (the rule
map equals JAX's), more where it does not (the JAX package clamps the grid
onto its face there, and its rule map departs from the true neighbours).

The outdoor datasets (SemanticKITTI, nuScenes, Waymo and their ColorNormal
variants) on scans this test writes in each layout by casting a small
sensor's rays against a street: `get_data` bit for bit, the SemanticKITTI
and nuScenes configs' pipelines and SemanticKITTI's test fragments on the
same seeds, the submission writers, and the nuScenes PTv3 config at small
depth: its eval forward and one train step against JAX's."""

import copy
import pickle
import random
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_torch_port_train import BOUNDS, _cos  # noqa: E402

from pointcept_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pointcept_tpu.engines.test import SemSegTester as JaxSemSegTester  # noqa: E402
from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.models.utils.convert import convert_state_dict  # noqa: E402
from pointcept_tpu.ops import serialization as jser  # noqa: E402
from pointcept_tpu.ops import sparse_conv as jsc  # noqa: E402
from pointcept_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_tpu.utils.optimizer import build_optimizer as jax_build_optimizer  # noqa: E402
from pointcept_tpu.utils.scheduler import build_scheduler as jax_build_scheduler  # noqa: E402
from pointcept_tpu_torch.datasets import build_dataset, point_collate_fn  # noqa: E402
from pointcept_tpu_torch.engines import SemSegTester, build_train_step, make_point_batch  # noqa: E402
from pointcept_tpu_torch.models import build_model  # noqa: E402
from pointcept_tpu_torch.models.utils import structure  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.ops import serialization as ser  # noqa: E402
from pointcept_tpu_torch.ops import sparse_conv as sc  # noqa: E402
from pointcept_tpu_torch.utils import build_optimizer, build_scheduler  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KITTI = str(ROOT / "configs/semantic_kitti/semseg-pt-v3m1-0-base.py")
NUSCENES = str(ROOT / "configs/nuscenes/semseg-pt-v3m1-0-base.py")
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


# ------------------------------------------------------------- the key fold


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


def _wide_batch(depth: int):
    """Unique voxels of two scenes: scene 0 reaches past ``2**depth`` cells
    (to 1.5 times that), scene 1 stays inside; shuffled together."""
    rng = np.random.RandomState(depth)
    span = 1 << depth
    wide = np.unique(rng.randint(0, span + span // 2, (3000, 3)), axis=0)
    wide[:50, 0] = span + rng.randint(0, span // 2, 50)  # past the depth on x for sure
    inside = np.unique(rng.randint(0, span, (2000, 3)), axis=0)
    grid = np.concatenate([wide, inside]).astype(np.int32)
    batch = np.concatenate([np.zeros(len(wide)), np.ones(len(inside))]).astype(np.int32)
    keep = np.unique(np.concatenate([batch[:, None], grid], 1), axis=0, return_index=True)[1]
    perm = rng.permutation(len(keep))
    return grid[keep][perm], batch[keep][perm]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("depth", [11, 12])
def test_fold_orders_a_grid_wider_than_its_depth(depth, order):
    """The port's order and inverse of the key triples equal the JAX
    package's lexicographic sort; its sorted scene ids never go back (the
    fold of ``batch << 3*depth`` put scene-0 keys past scene 1's)."""
    grid, batch = _wide_batch(depth)
    assert grid.max() >= 1 << depth
    keys = ser.encode(torch.as_tensor(grid), torch.as_tensor(batch), depth, order)
    jkeys = np.asarray(jser.encode(jnp.asarray(grid), jnp.asarray(batch), depth, order))
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    got = ser.argsort_keys(keys, depth)
    want = np.asarray(jser.argsort_keys(jnp.asarray(jkeys), depth))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ser.invert_order(got).numpy(),
                                  np.asarray(jser.invert_order(jnp.asarray(want))))
    assert (np.diff(batch[got.numpy()]) >= 0).all()
    old = (keys[:, 0].long() << (3 * depth)) | (keys[:, 1].long() << 30) | keys[:, 2].long()
    assert (np.diff(batch[torch.sort(old, stable=True).indices.numpy()]) < 0).any()


@pytest.mark.parametrize("depth", [11, 12])
def test_lex_lookup_of_a_grid_wider_than_its_depth(depth):
    """`lex_lookup` of present and absent triples of both scenes in the
    sorted table equals the JAX package's `lex_lookup`."""
    grid, batch = _wide_batch(depth)
    keys = ser.encode(torch.as_tensor(grid), torch.as_tensor(batch), depth, "z")
    table = keys[ser.argsort_keys(keys, depth).long()]
    rng = np.random.RandomState(1)
    pick = rng.choice(len(grid), 500)
    probe = np.concatenate([grid[pick], rng.randint(0, 3 << (depth - 1), (500, 3))])
    pbatch = np.concatenate([batch[pick], rng.randint(0, 2, 500)]).astype(np.int32)
    query = ser.encode(torch.as_tensor(probe.astype(np.int32)), torch.as_tensor(pbatch), depth, "z")
    got = sc.lex_lookup(table, query).numpy()
    t, q = jnp.asarray(table.numpy()), jnp.asarray(query.numpy())
    want = np.asarray(jsc.lex_lookup(t[:, 0], t[:, 1], t[:, 2], q[:, 0], q[:, 1], q[:, 2]))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() >= 500


def _true_neighbours(grid, batch, k: int) -> np.ndarray:
    index = {(int(b), *map(int, g)): i for i, (b, g) in enumerate(zip(batch, grid))}
    offs = sc.kernel_offsets(k)
    return np.array([[index.get((int(b), *map(int, g + o)), -1) for o in offs] for b, g in zip(batch, grid)],
                     dtype=np.int32)


def _rule_maps(grid, batch, depth):
    n = len(grid)
    mask = np.ones(n, bool)
    got = sc.build_subm_neighbor_map(torch.as_tensor(grid), torch.as_tensor(batch), torch.as_tensor(mask),
                                     depth, 3).numpy()
    want = np.asarray(jsc.build_subm_neighbor_map(jnp.asarray(grid), jnp.asarray(batch), jnp.asarray(mask),
                                                  depth, 3))
    return got, want


def test_rule_map_in_range_equals_jax():
    """A batch inside its depth: the serialization depth is the config's,
    and the rule map is the JAX package's and the true neighbours."""
    rng = np.random.RandomState(4)
    grid = np.unique(rng.randint(0, 30, (1500, 3)), axis=0).astype(np.int32)
    batch = (np.arange(len(grid)) % 2).astype(np.int32)
    pb = SimpleNamespace(grid_depth=structure.grid_bits(grid))
    depth = structure.serialization_depth(5, pb)
    assert depth == 5
    got, want = _rule_maps(grid, batch, depth)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _true_neighbours(grid, batch, 3))


def test_jax_rule_map_clamps_past_its_depth():
    """Past the depth the port serializes deeper (the reference's depth
    from the data) and finds the true neighbours; the JAX package clamps
    every coordinate onto the grid's face and links voxels that are not
    neighbours. A depth past 16 bits raises, naming the config's."""
    rng = np.random.RandomState(5)
    grid = np.unique(rng.randint(0, 48, (2500, 3)), axis=0).astype(np.int32)
    batch = np.zeros(len(grid), np.int32)
    pb = SimpleNamespace(grid_depth=structure.grid_bits(grid))
    depth = structure.serialization_depth(5, pb)
    assert depth == 6
    truth = _true_neighbours(grid, batch, 3)
    got, _ = _rule_maps(grid, batch, depth)
    np.testing.assert_array_equal(got, truth)
    _, jax_clamped = _rule_maps(grid, batch, 5)
    assert (jax_clamped != truth).any()
    with pytest.raises(ValueError, match="serialize_depth=12"):
        structure.serialization_depth(12, SimpleNamespace(grid_depth=17))


# ------------------------------------------------------------ scans, layouts


SENSOR = dict(beams=16, elevation=(10.67, -30.67), steps=256, height=1.84, max_range=100.0)
# a street: facades on both sides, two cars, a block down the street
BOXES = (((-30.0, 10.0, 0.0), (30.0, 20.0, 8.0), "building"), ((-30.0, -22.0, 0.0), (30.0, -12.0, 6.0), "building"),
         ((5.0, -3.0, 0.0), (9.5, -1.2, 1.5), "car"), ((-12.0, 1.5, 0.0), (-7.5, 3.3, 1.6), "car"),
         ((60.0, -20.0, 0.0), (70.0, 20.0, 15.0), "building"))
RAW = {"kitti": dict(road=40, sidewalk=48, building=50, car=10, unlabeled=0),
       "nuscenes": dict(road=24, sidewalk=26, building=28, car=17, unlabeled=0),
       "waymo": dict(road=18, sidewalk=22, building=14, car=1, unlabeled=0)}


def _scan(seed: int, sensor: str) -> dict:
    """A small ring scan of the street: one return a ray (its nearest box
    or the ground), 1 cm range noise, strength by class and range, the
    dataset's raw ids (2% unlabelled), instance ids of the cars."""
    rng = np.random.RandomState(seed)
    s = SENSOR
    el = np.deg2rad(np.linspace(*s["elevation"], s["beams"]))
    az = np.linspace(0, 2 * np.pi, s["steps"], endpoint=False) + rng.uniform(0, 2 * np.pi / s["steps"])
    e, a = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1).reshape(-1, 3)
    lo = np.array([b[0] for b in BOXES]) - [0, 0, s["height"]]
    hi = np.array([b[1] for b in BOXES]) - [0, 0, s["height"]]
    with np.errstate(divide="ignore", invalid="ignore"):
        ta, tb = lo[None] / d[:, None], hi[None] / d[:, None]
        tmin, tmax = np.minimum(ta, tb).max(2), np.maximum(ta, tb).min(2)
        t_box = np.where((tmax >= tmin) & (tmin > 0), tmin, np.inf)
        t_gnd = np.where(d[:, 2] < 0, -s["height"] / d[:, 2], np.inf)
    t = np.concatenate([t_box, t_gnd[:, None]], 1)
    hit = t.argmin(1)
    dist = t[np.arange(len(t)), hit]
    keep = dist < s["max_range"]
    hit, dist, d = hit[keep], dist[keep] + rng.normal(0, 0.01, keep.sum()), d[keep]
    coord = (d * dist[:, None]).astype(np.float32)
    cls = np.array([BOXES[h][2] if h < len(BOXES) else "road" if abs(c[1]) < 4 else "sidewalk"
                    for h, c in zip(hit, coord)])
    raw = np.array([RAW[sensor][c] for c in cls])
    raw[rng.rand(len(raw)) < 0.02] = RAW[sensor]["unlabeled"]
    strength = np.clip(np.where(cls == "car", 0.5, 0.2) * (1 - dist / 200) + rng.normal(0, 0.02, len(dist)), 0, 1)
    return dict(coord=coord, strength=strength.astype(np.float32), raw=raw,
                instance=np.where(cls == "car", hit + 1, 0), ring=np.nonzero(keep)[0] // s["steps"])


def _write_kitti(root: Path):
    for seq, seeds in (("00", (0, 1)), ("08", (2,)), ("11", (3,))):
        base = root / "dataset" / "sequences" / seq
        (base / "velodyne").mkdir(parents=True)
        if seq != "11":
            (base / "labels").mkdir()
        for i, seed in enumerate(seeds):
            s = _scan(seed, "kitti")
            np.concatenate([s["coord"], s["strength"][:, None]], 1).astype(np.float32).tofile(
                base / "velodyne" / f"{i:06d}.bin")
            if seq != "11":
                ((s["instance"].astype(np.uint32) << 16) | s["raw"].astype(np.uint32)).tofile(
                    base / "labels" / f"{i:06d}.label")


def _write_nuscenes(root: Path):
    for sub in ("raw/samples/LIDAR_TOP", "raw/lidarseg", "info"):
        (root / sub).mkdir(parents=True)
    for split, seeds in (("train", (0, 1)), ("val", (2,)), ("test", (3,))):
        infos = []
        for seed in seeds:
            s = _scan(seed, "nuscenes")
            info = dict(lidar_path=f"samples/LIDAR_TOP/n008__LIDAR_TOP__{1000 + seed}.pcd.bin",
                        lidar_token=f"{seed:032x}")
            np.concatenate([s["coord"], s["strength"][:, None] * 255, s["ring"][:, None]], 1).astype(
                np.float32).tofile(root / "raw" / info["lidar_path"])
            if split != "test":
                info["gt_segment_path"] = f"lidarseg/{seed:032x}_lidarseg.bin"
                s["raw"].astype(np.uint8).tofile(root / "raw" / info["gt_segment_path"])
            infos.append(info)
        with open(root / "info" / f"nuscenes_infos_10sweeps_{split}.pkl", "wb") as f:
            pickle.dump(infos, f)


def _write_waymo(root: Path):
    for split, seeds in (("train", (0, 1)), ("val", (2,))):
        for seed in seeds:
            d = root / split / f"segment-{seed}" / "1550083467346370"
            d.mkdir(parents=True)
            s = _scan(seed, "waymo")
            np.save(d / "coord.npy", s["coord"])
            np.save(d / "strength.npy", s["strength"][:, None])
            np.save(d / "segment.npy", s["raw"].astype(np.int32))


def _layout(root: Path, kind: str) -> dict:
    {"kitti": _write_kitti, "nuscenes": _write_nuscenes, "waymo": _write_waymo}[kind](root)
    return dict(type={"kitti": "SemanticKITTIDataset", "nuscenes": "NuScenesDataset",
                      "waymo": "WaymoDataset"}[kind], data_root=str(root))


def _assert_same(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, (what, key)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")
        else:
            assert g == w, (what, key)


@pytest.mark.parametrize("kind", ["kitti", "nuscenes", "waymo"])
@pytest.mark.parametrize("variant", ["", "ColorNormal"])
def test_get_data_equals_jax(tmp_path, kind, variant):
    """Each dataset's scan list and `get_data` dicts, bit for bit, over the
    splits of each layout (a list of splits; Waymo reads its first)."""
    cfg = _layout(tmp_path, kind)
    cfg["type"] = cfg["type"].replace("Dataset", f"{variant}Dataset")
    for split in (["train", "val"], "val"):
        ds, jds = build_dataset(dict(cfg, split=split)), jax_build_dataset(dict(cfg, split=split))
        assert ds.data_list == jds.data_list and len(ds) >= 1
        for idx in range(len(ds)):
            got = ds.get_data(idx)
            _assert_same(got, jds.get_data(idx), f"{split} {idx}")
            assert got["segment"].shape == (got["coord"].shape[0],)
            assert (got["segment"] == -1).any() and got["segment"].max() > 0
            if variant:
                assert not got["color"].any() and not got["normal"].any()


def test_kitti_labels_keep_the_semantic_half(tmp_path):
    """The `.label` instance ids in the upper 16 bits do not reach the
    classes; a scan without labels gets zeros; names are ``<seq>_<frame>``."""
    _write_kitti(tmp_path)
    ds = build_dataset(dict(type="SemanticKITTIDataset", data_root=str(tmp_path), split=["train", "test"]))
    assert [ds.get_data_name(i) for i in range(len(ds))] == ["00_000000", "00_000001", "11_000000"]
    raw = np.fromfile(tmp_path / "dataset/sequences/00/labels/000000.label", dtype=np.uint32)
    assert (raw >> 16).any()
    lut = ds.learning_map
    np.testing.assert_array_equal(ds.get_data(0)["segment"], [lut[int(v)] for v in raw & 0xFFFF])
    assert not ds.get_data(2)["segment"].any()


def _seeded(ds, idx, seed):
    np.random.seed(seed)
    random.seed(seed)
    return ds[idx]


@pytest.mark.parametrize("kind,path", [("kitti", KITTI), ("nuscenes", NUSCENES)])
@pytest.mark.parametrize("split", ["train", "val"])
def test_config_pipeline_equals_jax(tmp_path, kind, path, split):
    """The configs' own pipelines on the same seeds: rotation, scale, flip,
    jitter, GridSample at 5 cm, SphereCrop (KITTI: random in train, center
    in val, at 120,000 points), ``feat_keys=("coord", "strength")``."""
    _layout(tmp_path, kind)
    options = {"data.train.data_root": str(tmp_path), "data.val.data_root": str(tmp_path)}
    got_cfg, want_cfg = Config.fromfile(path), JaxConfig.fromfile(path)
    got_cfg.merge_from_dict(options)
    want_cfg.merge_from_dict(options)
    ds, jds = build_dataset(dict(got_cfg.data[split])), jax_build_dataset(dict(want_cfg.data[split]))
    assert len(ds) == len(jds) > 0
    for idx in range(len(ds)):
        for seed in (idx, 100 + idx):
            got = _seeded(ds, idx, seed)
            _assert_same(got, _seeded(jds, idx, seed), f"{idx} {seed}")
            assert got["feat"].shape[1] == 4


def test_kitti_sphere_crop_equals_jax(tmp_path):
    """SphereCrop's random and center modes where they cut (point_max below
    the scan's voxels), bit for bit."""
    _layout(tmp_path, "kitti")
    for mode in ("random", "center"):
        for split in ("train", "val"):
            transform = [dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
                              return_grid_coord=True),
                         dict(type="SphereCrop", point_max=1000, mode=mode), dict(type="ToTensor"),
                         dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                              feat_keys=("coord", "strength"))]
            cfg = dict(type="SemanticKITTIDataset", split=split, data_root=str(tmp_path), transform=transform)
            ds, jds = build_dataset(copy.deepcopy(cfg)), jax_build_dataset(copy.deepcopy(cfg))
            got = _seeded(ds, 0, 7)
            _assert_same(got, _seeded(jds, 0, 7), f"{mode} {split}")
            assert got["coord"].shape[0] == 1000


def test_kitti_test_fragments_equal_jax(tmp_path):
    """The KITTI config's test section (4 rotation views, GridSample's test
    mode): the fragment list bit for bit."""
    _layout(tmp_path, "kitti")
    got_cfg, want_cfg = Config.fromfile(KITTI), JaxConfig.fromfile(KITTI)
    for cfg in (got_cfg, want_cfg):
        cfg.merge_from_dict({"data.test.data_root": str(tmp_path)})
    port, ref = build_dataset(dict(got_cfg.data.test)), jax_build_dataset(dict(want_cfg.data.test))
    got, want = _seeded(port, 0, 0), _seeded(ref, 0, 0)
    got_frags, want_frags = got.pop("fragment_list"), want.pop("fragment_list")
    _assert_same(got, want)
    assert len(got_frags) == len(want_frags) >= 4  # a fragment or more a view
    for i, (g, w) in enumerate(zip(got_frags, want_frags)):
        _assert_same(g, w, f"fragment {i}")


# ------------------------------------------------------------ submissions


def _tester(ds_type, dataset):
    return SimpleNamespace(cfg=Config(dict(data=dict(test=dict(type=ds_type)))), test_dataset=dataset)


def test_kitti_submission_equals_jax(tmp_path):
    """``sequences/<seq>/predictions/<frame>.label``: the raw ids of
    `learning_map_inv`, uint32, the JAX writer's bytes."""
    _write_kitti(tmp_path / "data")
    cfg = dict(type="SemanticKITTIDataset", data_root=str(tmp_path / "data"), split="test")
    pred = np.random.RandomState(0).randint(0, 19, 5000)
    for writer, ds, sub in ((SemSegTester, build_dataset(dict(cfg)), "port"),
                            (JaxSemSegTester, jax_build_dataset(dict(cfg)), "jax")):
        writer.write_submission(_tester("SemanticKITTIDataset", ds), str(tmp_path / sub), "11_000000", pred)
    path = "sequences/11/predictions/000000.label"
    got = (tmp_path / "port" / path).read_bytes()
    assert got == (tmp_path / "jax" / path).read_bytes()
    ids = np.frombuffer(got, dtype=np.uint32)
    inv = build_dataset(dict(cfg)).learning_map_inv
    np.testing.assert_array_equal(ids, [inv[int(p)] for p in pred])


def test_nuscenes_submission_in_the_challenge_format(tmp_path):
    """The lidarseg challenge's format (nuScenes-devkit
    `eval/lidarseg/README.md`): ``lidarseg/test/<lidar sample_data
    token>_lidarseg.bin`` of uint8 class ids 1-16 (the 16 classes in the
    config's order, 0 never predicted), and ``test/submission.json``."""
    _write_nuscenes(tmp_path / "data")
    ds = build_dataset(dict(type="NuScenesDataset", data_root=str(tmp_path / "data"), split="test"))
    name = ds.get_data_name(0)
    pred = np.random.RandomState(0).randint(0, 16, 4000)
    from pointcept_tpu_torch.engines.test import write_nuscenes_meta

    write_nuscenes_meta(str(tmp_path / "port"))
    SemSegTester.write_submission(_tester("NuScenesDataset", ds), str(tmp_path / "port"), name, pred)
    files = list((tmp_path / "port" / "lidarseg" / "test").iterdir())
    assert [f.name for f in files] == [f"{3:032x}_lidarseg.bin"]
    got = np.fromfile(files[0], dtype=np.uint8)
    np.testing.assert_array_equal(got, pred + 1)
    import json

    meta = json.loads((tmp_path / "port" / "test" / "submission.json").read_text())["meta"]
    assert meta == dict(use_camera=False, use_lidar=True, use_radar=False, use_map=False, use_external=False)


def test_jax_nuscenes_submission_departs_from_the_challenge_format(tmp_path):
    """The JAX writer names each file by the lidar file's stem, not the
    lidar token, and writes the 32-category ids of `learning_map_inv`
    (values past 16, which the challenge's validator refuses)."""
    _write_nuscenes(tmp_path / "data")
    jds = jax_build_dataset(dict(type="NuScenesDataset", data_root=str(tmp_path / "data"), split="test"))
    name = jds.get_data_name(0)
    pred = np.arange(16)
    cfg = JaxConfig(dict(data=dict(test=dict(type="NuScenesDataset"))))
    JaxSemSegTester.write_submission(SimpleNamespace(cfg=cfg, test_dataset=jds), str(tmp_path / "jax"), name, pred)
    files = list((tmp_path / "jax" / "lidarseg" / "test").iterdir())
    assert [f.name for f in files] == [f"{name}_lidarseg.bin"] and not name.startswith(f"{3:032x}")
    got = np.fromfile(files[0], dtype=np.uint8)
    assert got.max() > 16
    np.testing.assert_array_equal(got, [jds.learning_map_inv[i] for i in range(16)])


def test_nuscenes_submission_needs_the_token(tmp_path):
    _write_nuscenes(tmp_path / "data")
    ds = build_dataset(dict(type="NuScenesDataset", data_root=str(tmp_path / "data"), split="test"))
    del ds.data_list[0]["lidar_token"]
    with pytest.raises(KeyError, match="lidar_token"):
        SemSegTester.write_submission(_tester("NuScenesDataset", ds), str(tmp_path), ds.get_data_name(0),
                                      np.zeros(10, np.int64))


# ------------------------------------------------ the nuScenes config's model


def _model_cfg(shuffle: bool):
    """The nuScenes PTv3 config's model at small depth: three stages,
    patch 128, drop path 0; its serialize_depth 12, gather engine, input
    (coord, strength), classes, losses."""
    model = Config.fromfile(NUSCENES).model
    backbone = dict(model.backbone, stride=(2, 2), enc_depths=(1, 1, 1), enc_channels=(32, 64, 128),
                    enc_num_head=(2, 4, 8), enc_patch_size=(128,) * 3, dec_depths=(1, 1), dec_channels=(32, 64),
                    dec_num_head=(2, 4), dec_patch_size=(128,) * 2, mlp_ratio=2, drop_path=0.0,
                    shuffle_orders=shuffle, sorted_layout=False, pool_capacity_factors=(1.0, 1.0))
    for key in ("attn_drop", "proj_drop", "enable_rpe", "enc_mode"):
        backbone.pop(key)
    return dict(model, backbone_out_channels=32, backbone=backbone,
                criteria=[dict(c) for c in model.criteria])


@pytest.fixture(scope="module")
def nuscenes_batch(tmp_path_factory):
    """Two sweeps through the config's val pipeline, collated, and JAX
    weights with non-trivial running statistics."""
    root = tmp_path_factory.mktemp("nuscenes")
    _write_nuscenes(root)
    cfg = Config.fromfile(NUSCENES)
    cfg.merge_from_dict({"data.train.data_root": str(root), "data.val.data_root": str(root)})
    ds = build_dataset(dict(cfg.data.train, split=["train", "val"], transform=cfg.data.val.transform))
    samples = [ds[0], ds[2]]
    arrays = point_collate_fn(samples, 8192)
    assert structure.grid_bits(arrays["grid_coord"]) <= 12  # inside the config's depth
    assert (arrays["batch"] == 1).sum() > 1000
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items() if k != "num_scenes"}, 2)
    model = jax_build_model(_model_cfg(False))
    variables = jax.jit(lambda r: model.init(r, pb, train=False))({"params": jax.random.PRNGKey(0)})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rs = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5,
                                   variables["batch_stats"])
    return dict(arrays=arrays, pb=pb, params=params, stats=stats, cfg=cfg)


def test_nuscenes_model_logits_match_jax(nuscenes_batch):
    """The eval forward of two sweeps inside the config's depth, at
    `tests/test_torch_port_ptv3.py`'s f32 bounds."""
    b = nuscenes_batch
    cfg = _model_cfg(False)
    jm = jax_build_model(cfg)
    want = np.asarray(jax.jit(lambda p, s: jm.apply({"params": p, "batch_stats": s}, b["pb"], train=False))(
        b["params"], b["stats"])["seg_logits"], np.float32)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(b["params"], b["stats"]), strict=True)
    res = model(make_point_batch(b["arrays"], 2, device="cpu"))
    assert sum(int(x) for vs in res["diagnostics"].values() for x in vs) == 0
    got = res["seg_logits"].float().numpy()
    v = b["arrays"]["batch"] >= 0
    err = np.abs(got[v] - want[v]).max() / np.abs(want[v]).max()
    agree = (got[v].argmax(1) == want[v].argmax(1)).mean()
    assert err < 1e-2 and agree > 0.99, (err, agree)


def test_nuscenes_train_step_matches_jax(nuscenes_batch, monkeypatch):
    """One train step of the config's recipe (shuffled orders with JAX's
    permutations replayed, CE + Lovász, AdamW with the ``block`` group,
    OneCycle), f32: loss, every gradient and the update at
    `tests/test_torch_port_train.py`'s bounds."""
    b = nuscenes_batch
    cfg = _model_cfg(True)
    recipe = b["cfg"]
    jm = jax_build_model(cfg)
    drawn, permutation = [], jax.random.permutation

    def recording(key, x, *args, **kwargs):
        out = permutation(key, x, *args, **kwargs)
        drawn.append(out)
        return out

    monkeypatch.setattr(jax.random, "permutation", recording)

    def loss_fn(params):
        drawn.clear()
        out, upd = jm.apply({"params": params, "batch_stats": b["stats"]}, b["pb"], train=True,
                            rngs={"shuffle": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                            mutable=["batch_stats", "diagnostics"])
        return out["loss"], list(drawn)

    (loss, perms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(b["params"])
    monkeypatch.setattr(jax.random, "permutation", permutation)
    perms = [np.asarray(p) for p in perms]
    assert len(perms) == 3  # serialization + 2 poolings

    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(b["params"], b["stats"]), strict=True)
    replay = iter(perms)
    monkeypatch.setattr(structure, "order_permutation", lambda n, generator: torch.as_tensor(np.array(next(replay))).long())
    optimizer = build_optimizer(dict(recipe.optimizer), model, recipe.param_dicts)
    scheduler = build_scheduler(dict(recipe.scheduler), optimizer, total_steps=1000)
    res = build_train_step(model, optimizer, scheduler)(make_point_batch(b["arrays"], 2, device="cpu"),
                                                        torch.Generator().manual_seed(0))
    got_grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    bounds = BOUNDS[False]
    assert abs(float(res["loss"]) - float(loss)) / abs(float(loss)) < bounds["loss"]
    assert int(res["pool_overflow"]) == 0

    jgrads = {n: g.numpy() for n, g in params_from_jax(jax.tree_util.tree_map(np.asarray, grads), {}).items()}
    gmax = max(np.abs(g).max() for g in got_grads.values())
    bad = {}
    for name, g in got_grads.items():
        w = jgrads[name]
        if np.abs(g).max() < 1e-6 * gmax:  # biases feeding train-mode BatchNorms: rounding noise
            if max(np.abs(g).max(), np.abs(w).max()) > 1e-3 * gmax:
                bad[name] = "vanishing gradient above the noise floor"
            continue
        err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        if not (err < bounds["grad"] and _cos(g, w) > bounds["cos"]):
            bad[name] = (err, _cos(g, w))
    assert not bad, bad

    # the update: JAX's optimizer chain on the port's gradients gives the
    # port's updated weights
    port_grads, _, unmatched = convert_state_dict(got_grads, "PT-v3m1")
    assert unmatched == []
    tx = jax_build_optimizer(dict(recipe.optimizer), b["params"],
                             jax_build_scheduler(dict(recipe.scheduler), total_steps=1000), recipe.param_dicts)
    updates, _ = tx.update(port_grads, tx.init(b["params"]), b["params"])
    want_sd = params_from_jax(optax.apply_updates(b["params"], updates), {})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[name].numpy(), rtol=1e-6, atol=1e-8, err_msg=name)
