"""The port's precise-eval tester against the JAX package's, on the CPU.

The tester's transforms (GridSample's test mode and `return_inverse`,
RandomRotateTargetAngle, Copy) and `DefaultDataset.prepare_test_data` must
give the JAX package's arrays bit for bit. `build_geometry` with the
forward on it must give the port's inline eval forward, and agree with the
JAX `build_geometry` + `precomputed` forward on the same weights. The
tester on the small grouped config of `tests/test_tester_device_accumulate.py`
(two orders, two stages, gather engine, capacity 4,096, 2,500 points) must
agree with the JAX tester on the same weights, and its grouped path with
its one-forward-a-fragment path. Then its errors, its resume and the size
checks of the kernel wrappers."""

import copy
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcept_tpu.datasets import build_dataset as jax_build_dataset
from pointcept_tpu.datasets.transform import TRANSFORMS as JAX_TRANSFORMS
from pointcept_tpu.engines.test import TESTERS as JAX_TESTERS
from pointcept_tpu.engines.train import make_point_batch as jax_point_batch
from pointcept_tpu.models import build_model as jax_build_model
from pointcept_tpu.utils.config import Config as JaxConfig
from pointcept_tpu_torch.datasets import TRANSFORMS, build_dataset, synthesize_scene, synthetic_arrays
from pointcept_tpu_torch.engines import TESTERS, make_point_batch
from pointcept_tpu_torch.models import build_model
from pointcept_tpu_torch.models.utils.convert import params_from_jax
from pointcept_tpu_torch.ops.kernels.block_fill import fill_sizes
from pointcept_tpu_torch.ops.kernels.patch_attention import attention_sizes
from pointcept_tpu_torch.ops.kernels.take_back import take_back_sizes
from pointcept_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
OVERFIT = str(ROOT / "configs/synthetic/semseg-pt-v3m1-1-overfit.py")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads keep these small runs fast beside the other test
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ data


def _scene(seed=0, n=3000):
    data = synthesize_scene(seed, num_points=n, num_classes=20, extent=3.0)
    data["color"] = data["color"].astype(np.float32)
    return data


def _assert_same(got, want, where=""):
    assert sorted(got) == sorted(want), where
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, (where, key)
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {key}")
        else:
            assert g == w, (where, key)


def _run(registry, cfg, data, seed):
    np.random.seed(seed)
    random.seed(seed)
    out = registry.build(dict(cfg))(copy.deepcopy(data))
    return out, np.random.get_state()[1].copy(), random.getstate()


TESTER_TRANSFORMS = [
    dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="test", return_grid_coord=True),
    dict(type="GridSample", grid_size=0.02, hash_type="fnv", mode="test", return_grid_coord=True,
         return_inverse=True),
    dict(type="GridSample", grid_size=0.033, hash_type="fnv", mode="train", return_inverse=True),
    dict(type="RandomRotateTargetAngle", angle=[1 / 2], axis="z", center=[0, 0, 0], p=1),
    dict(type="RandomRotateTargetAngle", angle=(1 / 2, 1, 3 / 2), axis="z", p=1),
    dict(type="RandomRotateTargetAngle", axis="x", p=0.0),
    dict(type="Copy", keys_dict={"segment": "origin_segment"}),
    dict(type="Copy"),
]


@pytest.mark.parametrize("cfg", TESTER_TRANSFORMS, ids=lambda c: f"{c['type']}-{c.get('mode', '')}")
def test_tester_transform_equals_jax(cfg):
    data = _scene(1)
    got, np_state, py_state = _run(TRANSFORMS, cfg, data, seed=3)
    want, np_want, py_want = _run(JAX_TRANSFORMS, cfg, data, seed=3)
    np.testing.assert_array_equal(np_state, np_want)
    assert py_state == py_want
    if isinstance(want, list):  # GridSample's test mode: the fragments
        assert isinstance(got, list) and len(got) == len(want) > 1
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"fragment {i}")
        # every fragment holds each voxel once; together they hold every point
        assert len({len(w["index"]) for w in want}) == 1
        covered = np.unique(np.concatenate([w["index"] for w in want]))
        np.testing.assert_array_equal(covered, np.arange(len(data["coord"])))
    else:
        _assert_same(got, want)


def _device_accumulate_test_section():
    """The test section of `tests/test_tester_device_accumulate.py`'s config."""
    return dict(
        type="SyntheticSemSegDataset", split="val", num_scenes=2, num_points=6000, num_classes=13,
        transform=[dict(type="CenterShift", apply_z=True), dict(type="NormalizeColor")],
        test_mode=True,
        test_cfg=dict(
            voxelize=dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="test",
                          return_grid_coord=True),
            crop=None,
            post_transform=[
                dict(type="CenterShift", apply_z=False), dict(type="ToTensor"),
                dict(type="Collect", keys=("coord", "grid_coord", "index"), feat_keys=("color", "normal")),
            ],
            aug_transform=[
                [dict(type="RandomRotateTargetAngle", angle=[0], axis="z", center=[0, 0, 0], p=1)],
                [dict(type="RandomRotateTargetAngle", angle=[1], axis="z", center=[0, 0, 0], p=1),
                 dict(type="RandomScale", scale=[0.95, 0.95])],
                [dict(type="RandomFlip", p=1)],
            ],
        ),
    )


def _overfit_test_section():
    return dict(Config.fromfile(OVERFIT).data.test)


@pytest.mark.parametrize("section", ["overfit", "device_accumulate"])
def test_prepare_test_data_equals_jax(section):
    cfg = _overfit_test_section() if section == "overfit" else _device_accumulate_test_section()
    port, ref = build_dataset(copy.deepcopy(cfg)), jax_build_dataset(copy.deepcopy(cfg))
    assert len(port) == len(ref)
    for idx in range(2):
        for mod in (np.random, random):
            mod.seed(idx)
        got = port[idx]
        for mod in (np.random, random):
            mod.seed(idx)
        want = ref[idx]
        got_frags, want_frags = got.pop("fragment_list"), want.pop("fragment_list")
        _assert_same(got, want, f"scene {idx}")
        assert len(got_frags) == len(want_frags) > 1
        for i, (g, w) in enumerate(zip(got_frags, want_frags)):
            _assert_same(g, w, f"scene {idx} fragment {i}")
        if section == "overfit":
            assert "origin_segment" in got and got["inverse"].shape == got["origin_segment"].shape


# -------------------------------------------------------------- geometry


def _backbone(engine):
    return dict(
        type="PT-v3m1", in_channels=6, order=("z", "z-trans", "hilbert"), stride=(2, 2),
        enc_depths=(1, 1, 1), enc_channels=(16, 32, 64), enc_num_head=(2, 4, 4),
        enc_patch_size=(64, 64, 64), dec_depths=(1, 1), dec_channels=(16, 32), dec_num_head=(2, 4),
        dec_patch_size=(64, 64), mlp_ratio=2, drop_path=0.0, shuffle_orders=False, serialize_depth=10,
        pool_capacity_factors=(0.6, 0.6), conv_engine=engine, block_bits=2, block_capacity_factor=1 / 8,
        block_engine_min_points=1024,
    )


def _model_cfg(engine):
    return dict(type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=16, backbone=_backbone(engine),
                criteria=[dict(type="CrossEntropyLoss", ignore_index=-1)])


def _template(arrays, scenes):
    """The batch without its features, as the tester gives `build_geometry`."""
    return make_point_batch({k: v for k, v in arrays.items() if k != "feat"}, scenes, device="cpu")


@pytest.fixture(scope="module")
def geometry_case():
    """Two scenes of 2,048 rows; the JAX model's weights and its logits from
    `build_geometry` + `precomputed`, for each conv engine."""
    arrays = synthetic_arrays(4096, 2, seed=3)
    arrays.pop("segment")
    arrays.pop("num_scenes")
    out = {}
    for engine in ("gather", "block"):
        cfg = _model_cfg(engine)
        model = jax_build_model(cfg)
        backbone = jax_build_model(cfg["backbone"])
        pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 2)
        variables = jax.jit(lambda r, x: model.init(r, x, train=False))({"params": jax.random.PRNGKey(1)}, pb)

        @jax.jit
        def forward(v, x):
            geom = backbone.build_geometry(x.replace(feat=None))
            res, st = model.apply(v, x, train=False, precomputed=geom, mutable=["diagnostics"])
            leaves = jax.tree_util.tree_leaves(st.get("diagnostics", {}))
            return res["seg_logits"], sum(jnp.sum(x).astype(jnp.int32) for x in leaves)

        logits, overflow = forward(variables, pb)
        tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        out[engine] = dict(weights=params_from_jax(tree(variables["params"]), tree(variables["batch_stats"])),
                           logits=np.asarray(logits, np.float32), overflow=int(overflow))
    return arrays, out


def _port_model(engine, weights):
    model = build_model(_model_cfg(engine), device="cpu")
    model.load_state_dict(weights, strict=True)
    return model


def _overflow(diag):
    return sum(int(v) for vs in diag.values() for v in vs)


@pytest.mark.parametrize("engine", ["gather", "block"])
def test_build_geometry_equals_inline_forward(geometry_case, engine):
    arrays, ref = geometry_case
    model = _port_model(engine, ref[engine]["weights"])
    pb = make_point_batch(arrays, 2, device="cpu")
    inline = model(pb)
    geom = model.backbone.build_geometry(_template(arrays, 2))
    shared = model(pb, precomputed=geom)
    valid = arrays["batch"] >= 0
    diff = (inline["seg_logits"] - shared["seg_logits"]).abs().numpy()[valid]
    assert diff.max() <= 1e-5
    assert _overflow(inline["diagnostics"]) == _overflow(shared["diagnostics"]) == int(geom["overflow"])
    assert list(shared["diagnostics"]["geom_overflow"]) == [geom["overflow"]]
    if engine == "block":
        assert int(geom["overflow"]) > 0  # the block capacity was chosen to overflow: its count is compared


@pytest.mark.parametrize("engine", ["gather", "block"])
def test_build_geometry_equals_jax(geometry_case, engine):
    arrays, ref = geometry_case
    model = _port_model(engine, ref[engine]["weights"])
    geom = model.backbone.build_geometry(_template(arrays, 2))
    res = model(make_point_batch(arrays, 2, device="cpu"), precomputed=geom)
    valid = arrays["batch"] >= 0
    got, want = res["seg_logits"].numpy()[valid], ref[engine]["logits"][valid]
    err = np.abs(got - want).max() / np.abs(want).max()
    agree = (got.argmax(1) == want.argmax(1)).mean()
    # f32 stream, bf16 conv and attention operands (tests/test_torch_port_ptv3.py)
    assert err < 1e-2 and agree > 0.99, (err, agree)
    assert int(geom["overflow"]) == ref[engine]["overflow"]


def test_build_geometry_refuses_train_mode(geometry_case):
    arrays, ref = geometry_case
    model = _port_model("gather", ref["gather"]["weights"]).train()
    with pytest.raises(ValueError, match="train mode"):
        model.backbone.build_geometry(_template(arrays, 2))
    geom = model.eval().backbone.build_geometry(_template(arrays, 2))
    with pytest.raises(ValueError, match="eval forward only"):
        model.train().backbone(make_point_batch(arrays, 2, device="cpu"), precomputed=geom)


# ---------------------------------------------------------------- tester


def _tester_cfg(save_path, **extra):
    """The small grouped config of tests/test_tester_device_accumulate.py
    (two orders, two stages, gather engine, capacity 4,096, 2,500-point
    scenes, one view)."""
    model = dict(
        type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=16,
        backbone=dict(
            type="PT-v3m1", in_channels=6, order=("z", "z-trans"), stride=(2,), enc_depths=(1, 1),
            enc_channels=(16, 32), enc_num_head=(2, 4), enc_patch_size=(64, 64), dec_depths=(1,),
            dec_channels=(16,), dec_num_head=(2,), dec_patch_size=(64,), mlp_ratio=2, drop_path=0.0,
            serialize_depth=10, pool_capacity_factors=(0.7,),
        ),
        criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
    )
    test = _device_accumulate_test_section()
    test.update(num_points=2500)
    test["test_cfg"]["aug_transform"] = test["test_cfg"]["aug_transform"][:1]
    cfg = dict(save_path=str(save_path), batch_size_test_per_gpu=1, point_capacity_test=4096, num_worker=0,
               seed=0, host_geometry=False, model=model,
               data=dict(num_classes=13, ignore_index=-1, names=[f"c{i}" for i in range(13)], test=test))
    cfg.update(extra)
    return cfg


def _preds(save_path):
    rd = os.path.join(str(save_path), "result")
    return {f: np.load(os.path.join(rd, f)) for f in sorted(os.listdir(rd)) if f.endswith("_pred.npy")}


@pytest.fixture(scope="module")
def jax_tester(tmp_path_factory):
    """The JAX tester's grouped path, run once: its weights (random, seed 0)
    in the port's names, its preds and its result."""
    save = tmp_path_factory.mktemp("jax_tester")
    tester = JAX_TESTERS.build(dict(type="SemSegTester", cfg=JaxConfig(_tester_cfg(save))))
    assert tester._fragment_geometry_ok()
    result = tester.test()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    weights = params_from_jax(tree(tester.state.params), tree(tester.state.batch_stats))
    return dict(weights=weights, preds=_preds(save), result=result)


def _port_tester(save_path, weights, **extra):
    tester = TESTERS.build(dict(type="SemSegTester", cfg=Config(_tester_cfg(save_path, **extra)), device="cpu"))
    tester.model.load_state_dict(weights, strict=True)
    return tester


def test_tester_equals_jax(jax_tester, tmp_path):
    tester = _port_tester(tmp_path, jax_tester["weights"])
    assert tester._fragment_geometry_ok()
    t0 = time.perf_counter()
    result = tester.test()
    wall_ms = (time.perf_counter() - t0) * 1e3
    preds = _preds(tmp_path)
    assert preds.keys() == jax_tester["preds"].keys() and len(preds) == 2
    for name, want in jax_tester["preds"].items():
        got = preds[name]
        assert got.shape == want.shape and np.isfinite(got).all()
        err = np.abs(got - want).max() / np.abs(want).max()
        agree = (got.argmax(1) == want.argmax(1)).mean()
        assert err < 1e-2 and agree > 0.99, (name, err, agree)
    assert abs(result["mIoU"] - jax_tester["result"]["mIoU"]) < 0.02
    stats = tester.scene_stats
    assert [s["groups"] for s in stats] == [1, 1] and all(s["dropped"] == 0 for s in stats)
    assert all(s["fragments"] > 1 and s["forwards"] == -(-s["fragments"] // 4) for s in stats)
    # each scene's time runs from its own start: the scenes' times do not
    # overlap (the JAX tester's per-scene time spans two scenes)
    assert sum(s["scene_ms"] for s in stats) <= wall_ms
    assert os.path.isfile(tmp_path / "result" / "record.npz")


def test_grouped_path_equals_per_fragment_path(jax_tester, tmp_path):
    grouped = _port_tester(tmp_path / "grouped", jax_tester["weights"])
    single = _port_tester(tmp_path / "single", jax_tester["weights"], fragment_geometry_reuse=False)
    assert not single._fragment_geometry_ok()
    res_g, res_s = grouped.test(), single.test()
    a, b = _preds(tmp_path / "grouped"), _preds(tmp_path / "single")
    assert a.keys() == b.keys() and a
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a[name].argmax(-1), b[name].argmax(-1))
    assert res_g["mIoU"] == res_s["mIoU"]
    assert all(s["groups"] is None and s["forwards"] == s["fragments"] for s in single.scene_stats)


def test_loader_workers_give_the_same_preds(jax_tester, tmp_path):
    """Scenes built and packed in two loader workers: the same bits."""
    serial = _port_tester(tmp_path / "serial", jax_tester["weights"])
    workers = _port_tester(tmp_path / "workers", jax_tester["weights"], num_worker=2)
    assert serial.test() == workers.test()
    a, b = _preds(tmp_path / "serial"), _preds(tmp_path / "workers")
    assert a.keys() == b.keys() and a
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
    assert all(s["host_ms"]["dataset"] > 0 for s in workers.scene_stats)


def test_second_test_reads_the_cached_preds(jax_tester, tmp_path):
    tester = _port_tester(tmp_path, jax_tester["weights"])
    first = tester.test()
    cached = _preds(tmp_path)
    tester.model.load_state_dict({k: torch.zeros_like(v) for k, v in tester.model.state_dict().items()})
    assert tester.test() == first  # the zeroed model is never run: every scene comes from its pred
    assert tester.scene_stats == []
    for name, pred in _preds(tmp_path).items():
        np.testing.assert_array_equal(pred, cached[name])


def test_full_resolution_mapping_and_submission(tmp_path):
    """The overfit config's test section (Copy, GridSample `return_inverse`):
    the pred is mapped back to every raw point; the submission writers."""
    cfg = Config.fromfile(OVERFIT)
    cfg.save_path = str(tmp_path)
    cfg.data.test.num_scenes = 1
    cfg.enable_amp = False
    cfg.num_worker = 0
    # at the config's (0.5, 0.5) the second pooling drops points (ROADMAP queue 3)
    cfg.model.backbone.pool_capacity_factors = (0.5, 0.75)
    tester = TESTERS.build(dict(type="SemSegTester", cfg=cfg, device="cpu"))
    result = tester.test()
    pred = _preds(tmp_path)["synthetic_train_0_pred.npy"]
    assert pred.shape == (cfg.data.test.num_points, cfg.data.num_classes)
    assert 0.0 <= result["allAcc"] <= 1.0
    tester.write_submission(str(tmp_path), "scene", pred.argmax(-1))
    np.testing.assert_array_equal(np.load(tmp_path / "scene_pred.npy"), pred.argmax(-1))
    # SemanticKITTI's: one uint32 .label a frame, the raw ids of learning_map_inv
    from pointcept_tpu_torch.datasets.semantic_kitti import SemanticKITTIDataset

    cfg.data.test.type = "SemanticKITTIDataset"
    inv = SemanticKITTIDataset.get_learning_map_inv(-1)
    tester.test_dataset = SemanticKITTIDataset.__new__(SemanticKITTIDataset)
    tester.test_dataset.learning_map_inv = inv
    labels = pred.argmax(-1) % 19
    tester.write_submission(str(tmp_path), "08_000000", labels)
    ids = np.fromfile(tmp_path / "sequences" / "08" / "predictions" / "000000.label", dtype=np.uint32)
    np.testing.assert_array_equal(ids, [inv[int(v)] for v in labels])


# ---------------------------------------------------------------- errors


@pytest.mark.parametrize("option", [dict(hash_type="ravel"), dict(return_displacement=True),
                                    dict(mode="val")])
def test_unported_grid_sample_options_raise(option):
    with pytest.raises((NotImplementedError, ValueError)):
        TRANSFORMS.build(dict(type="GridSample", **option))


def test_fragment_batch_below_one_raises(tmp_path):
    with pytest.raises(ValueError, match="tester_fragment_batch"):
        TESTERS.build(dict(type="SemSegTester", cfg=Config(_tester_cfg(tmp_path, tester_fragment_batch=0)),
                           device="cpu"))


@pytest.mark.parametrize("reuse", [True, False])
def test_fragment_above_capacity_raises(tmp_path, reuse):
    tester = TESTERS.build(dict(type="SemSegTester", device="cpu", cfg=Config(_tester_cfg(
        tmp_path, point_capacity_test=512, fragment_geometry_reuse=reuse))))
    with pytest.raises(ValueError, match="point_capacity_test 512"):
        tester.test()


def test_check_dropped_raises_above_its_tolerance(tmp_path):
    tester = TESTERS.build(dict(type="SemSegTester", device="cpu",
                                cfg=Config(_tester_cfg(tmp_path, eval_overflow_tolerance=1e-2))))
    tester.check_dropped(0, 1000, "none")
    tester.check_dropped(10, 1000, "at the tolerance")  # logged
    with pytest.raises(RuntimeError, match="dropped 11/1000"):
        tester.check_dropped(11, 1000, "above")


def test_tight_pool_capacity_raises_in_the_test(tmp_path):
    cfg = _tester_cfg(tmp_path)
    cfg["model"]["backbone"]["pool_capacity_factors"] = (0.05,)
    tester = TESTERS.build(dict(type="SemSegTester", cfg=Config(cfg), device="cpu"))
    with pytest.raises(RuntimeError, match="static capacity dropped"):
        tester.test()


def test_host_accumulation_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="device_accumulate"):
        TESTERS.build(dict(type="SemSegTester", cfg=Config(_tester_cfg(tmp_path, device_accumulate=False)),
                           device="cpu"))


def test_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run on it")
    from pointcept_tpu_torch.engines import default_config_parser
    from pointcept_tpu_torch.engines.test import main_worker

    def parsed(sub):
        return default_config_parser(OVERFIT, {"save_path": str(tmp_path / sub), "num_worker": 0,
                                               "enable_amp": False, "data.test.num_scenes": 1,
                                               "model.backbone.pool_capacity_factors": (0.5, 0.75)})

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TESTERS.build(dict(type="SemSegTester", cfg=Config(_tester_cfg(tmp_path / "a"))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_worker(parsed("b"))
    _, result = main_worker(parsed("c"), device="cpu")
    assert 0.0 <= result["mIoU"] <= 1.0
    out = subprocess.run([sys.executable, str(ROOT / "tools/torch_port_test.py"), "--config-file", OVERFIT,
                          "--options", f"save_path={tmp_path / 'd'}", "num_worker=0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


# ------------------------------------------------------- kernel int range


def test_kernel_wrappers_refuse_the_int32_overflow():
    """The tester's stage 0 (four fragments of 262,144 rows, 8^3 tiles at
    1/32, C 64) fits the kernels' int range; four times it does not."""
    fill_sizes(1 << 20, 64, 1 << 15, 512)
    take_back_sizes(1 << 20, ((1 << 15) + 1) * 512, 64)
    attention_sizes(1028, 1024, 64, 4)
    with pytest.raises(ValueError, match="block_fill: out_elements"):
        fill_sizes(1 << 22, 64, 1 << 17, 512)
    with pytest.raises(ValueError, match="take_back_rows: dense_elements"):
        take_back_sizes(1 << 22, ((1 << 17) + 1) * 512, 64)
    with pytest.raises(ValueError, match="patch_attention: qkv_elements"):
        attention_sizes(1 << 13, 1024, 128, 4)
