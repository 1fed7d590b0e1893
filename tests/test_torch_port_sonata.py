"""Sonata pretraining and PT-v3m2 in the port against the JAX package, on the CPU.

The same numpy inputs from a seed go through both packages: the four new
transforms and the Sonata config's whole train pipeline (bit for bit, with
the generators' states), the multi-view collate (bit for bit), PT-v3m2's
encoder (mask token, LayerScale) and its decoder path, OnlineCluster,
Sinkhorn, kNN, the grid-patch mask on JAX's own mask scores, one Sonata
train step (losses, student gradients, the update and the EMA teacher),
SonataHook against JAX's `CosineScheduler`, and the port's trainer
against the JAX trainer on a tiny Sonata config. Then the port alone:
resume bit for bit, the weight-decay hook, the converter, what raises.

Three faults of the JAX side are not copied, and the tests say where:
the JAX `Collect` replaces MultiViewGenerator's per-view offsets with one
count (so JAX-side comparisons use a Collect that keeps them); the JAX
`WeightDecaySchedular` rebuilds the optimizer without its teacher mask
(so the trainers are compared without it); the config's
``head_in_channels=1232`` is not what up_cast gives (1,088)."""

import copy
import json
import os
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

from test_reference_oracle import _surface_scene  # noqa: E402
from test_torch_port_trainer import OneDeviceJaxTrainer  # noqa: E402

from pointcept_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pointcept_tpu.datasets.transform import TRANSFORMS as JAX_TRANSFORMS  # noqa: E402
from pointcept_tpu.datasets.transform import Compose as JaxCompose  # noqa: E402
from pointcept_tpu.datasets.utils import point_collate_fn as jax_point_collate_fn  # noqa: E402
from pointcept_tpu.engines.defaults import default_config_parser as jax_config_parser  # noqa: E402
from pointcept_tpu.engines.defaults import default_setup as jax_setup  # noqa: E402
from pointcept_tpu.engines.hooks.misc import SonataHook as JaxSonataHook  # noqa: E402
from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.engines.train import make_view_inputs as jax_view_inputs  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.models.sonata import sinkhorn_knopp as jax_sinkhorn  # noqa: E402
from pointcept_tpu.models.sonata.sonata import OnlineCluster as JaxOnlineCluster  # noqa: E402
from pointcept_tpu.models.utils.convert import convert_ptv3  # noqa: E402
from pointcept_tpu.ops.pointops import knn_query as jax_knn  # noqa: E402
from pointcept_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_tpu.utils.optimizer import build_optimizer as jax_build_optimizer  # noqa: E402
from pointcept_tpu.utils.scheduler import CosineScheduler as JaxCosineScheduler  # noqa: E402
from pointcept_tpu.utils.scheduler import build_scheduler as jax_build_scheduler  # noqa: E402
from pointcept_tpu_torch.datasets import TRANSFORMS, Compose, build_dataset, point_collate_fn  # noqa: E402
from pointcept_tpu_torch.datasets import synthesize_scene  # noqa: E402
from pointcept_tpu_torch.engines import (  # noqa: E402
    Trainer, build_train_step, default_config_parser, default_setup, main_worker, make_point_batch,
    make_view_inputs,
)
from pointcept_tpu_torch.engines.hooks import SonataHook, WeightDecaySchedular  # noqa: E402
from pointcept_tpu_torch.models import MODELS, build_model  # noqa: E402
from pointcept_tpu_torch.models.sonata import OnlineCluster, sinkhorn_knopp  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import SONATA_ROOTS, params_from_jax  # noqa: E402
from pointcept_tpu_torch.ops.pointops import knn_query  # noqa: E402
from pointcept_tpu_torch.utils import build_optimizer, build_scheduler  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402
from pointcept_tpu_torch.utils.scheduler import CosineScheduler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SONATA = str(ROOT / "configs/sonata/pretrain-sonata-v1m1-0-base.py")
SCRATCH = str(ROOT / "configs/scannet/semseg-pt-v3m2-0-sonata-scratch.py")

# PT-v3m2 at test width: 3 stages, head dim 16, patch 64, the Sonata
# options (mask token, LayerScale 1e-5), no randomness (drop path 0,
# unshuffled orders: JAX and the port draw from different generators)
BACKBONE = dict(type="PT-v3m2", in_channels=6, order=("z", "z-trans"), stride=(2, 2), enc_depths=(1, 1, 2),
                enc_channels=(16, 16, 32), enc_num_head=(1, 1, 2), enc_patch_size=(64,) * 3, mlp_ratio=2,
                drop_path=0.0, shuffle_orders=False, enc_mode=True, mask_token=True, layer_scale=1e-5,
                serialize_depth=8, pool_capacity_factors=(0.75, 0.75))
# Sonata over its two-stage cut (each JAX compile of a Sonata step takes
# ~19 s here at two stages, ~28 s at three)
SONATA_BACKBONE = dict(BACKBONE, stride=(2,), enc_depths=(1, 1), enc_channels=(16, 16), enc_num_head=(1, 1),
                       enc_patch_size=(64, 64), pool_capacity_factors=(1.0,))
SONATA_MODEL = dict(type="Sonata-v1m1", backbone=SONATA_BACKBONE, head_in_channels=32, head_hidden_channels=32,
                    head_embed_channels=16, head_num_prototypes=24, match_max_r=0.08, up_cast_level=1)
HYPER = dict(mask_size=0.3, mask_ratio=0.5, teacher_temp=0.05)
LOSSES = ("mask_loss", "roll_mask_loss", "unmask_loss")
# the Sonata config's view transforms at test size; `offset_keys_dict={}`
# with the offsets among the keys keeps the per-view offsets in both
# packages. The views carry GridSample's grid coordinates: voxels computed
# again from a view's own corner can hold two points, whose tied curve keys
# the two packages' sorts order differently
COLOR_AUG = [dict(type="RandomColorJitter", brightness=0.4, contrast=0.4, saturation=0.2, hue=0.02, p=0.8),
             dict(type="RandomColorGrayScale", p=0.2), dict(type="RandomColorDrop", p=0.2)]
VIEWS = dict(type="MultiViewGenerator", global_view_num=2, global_view_scale=(0.4, 1.0), local_view_num=4,
             local_view_scale=(0.1, 0.4), global_shared_transform=[dict(type="ChromaticAutoContrast", p=0.2)],
             global_transform=COLOR_AUG, local_transform=COLOR_AUG,
             view_keys=("coord", "origin_coord", "color", "normal", "grid_coord"))
VIEW_KEYS = ("global_coord", "global_origin_coord", "global_grid_coord", "local_coord", "local_origin_coord",
             "local_grid_coord")
PIPELINE = [dict(type="CenterShift", apply_z=True),
            dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train", return_grid_coord=True),
            dict(type="Copy", keys_dict={"coord": "origin_coord"}), dict(type="NormalizeColor"), VIEWS,
            dict(type="Collect", keys=VIEW_KEYS + ("global_offset", "local_offset"), offset_keys_dict={},
                 global_feat_keys=("global_color", "global_normal"),
                 local_feat_keys=("local_color", "local_normal"))]
# one train step in f32: loss, per-tensor gradient relative L2 and cosine
# (the bounds of tests/test_torch_port_train.py; AMP is held against JAX in
# the encoder test, at the slice's bound)
BOUND = dict(loss=2e-2, grad=5e-2, cos=0.999)
OPTIMIZER = dict(type="AdamW", lr=0.004, weight_decay=0.04)
SCHEDULER = dict(type="OneCycleLR", max_lr=0.004, pct_start=0.05, anneal_strategy="cos", div_factor=10.0,
                 final_div_factor=1000.0)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cos(got, want):
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _assert_same(got, want, skip=()):
    assert sorted(got) == sorted(want)
    for key in want:
        if key in skip:
            continue
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def _rng_state():
    return np.random.get_state()[1].copy(), np.random.get_state()[2], random.getstate()


def _scene(seed, n=4000):
    d = synthesize_scene(seed, num_points=n, num_classes=20, extent=3.0)
    d["color"] = d["color"].astype(np.float32)
    return d


def _samples(pipeline, seeds=(0, 1)):
    out = []
    for s in seeds:
        np.random.seed(100 + s)
        random.seed(100 + s)
        out.append(pipeline(_scene(s)))
    return out


# ------------------------------------------------------------ the data


COLOR_CASES = [
    dict(type="RandomColorGrayScale", p=1.0), dict(type="RandomColorGrayScale", p=0.0),
    dict(type="RandomColorDrop", p=1.0), dict(type="RandomColorDrop", p=0.0),
    dict(type="RandomColorDrop", p=1.0, color_augment=0.5),
    dict(type="RandomColorJitter", brightness=0.4, contrast=0.4, saturation=0.2, hue=0.02, p=1.0),
    dict(type="RandomColorJitter", brightness=0.4, contrast=0.4, saturation=0.2, hue=0.02, p=0.8),
    dict(type="RandomColorJitter", brightness=0, contrast=0.4, saturation=(0.5, 1.5), hue=0, p=1.0),
    VIEWS, dict(VIEWS, shared_global_view=True, center_height_scale=(0.5, 1.0), max_size=1000),
]


@pytest.mark.parametrize("cfg", COLOR_CASES, ids=lambda c: c["type"])
def test_transforms_match_jax(cfg):
    for seed in (0, 1):
        data = _scene(seed)
        data["color"] = (data["color"] / 255).astype(np.float32) if seed else data["color"]
        data["origin_coord"] = data["coord"].copy()
        data["grid_coord"] = np.floor(data["coord"] / 0.05).astype(np.int64)
        outs = []
        for registry in (TRANSFORMS, JAX_TRANSFORMS):
            np.random.seed(seed)
            random.seed(seed)
            outs.append((registry.build(copy.deepcopy(dict(cfg)))(copy.deepcopy(data)), _rng_state()))
        (got, got_state), (want, want_state) = outs
        _assert_same(got, want)
        np.testing.assert_array_equal(got_state[0], want_state[0])
        assert got_state[1:] == want_state[1:]


def _write_scannet(root: Path, seeds, n=20000):
    for seed in seeds:
        d = root / "train" / f"scene{seed:04d}_00"
        d.mkdir(parents=True)
        s = synthesize_scene(seed, num_points=n, num_classes=20, extent=3.0)
        for key, dtype in (("coord", None), ("color", np.uint8), ("normal", None)):
            np.save(d / f"{key}.npy", s[key] if dtype is None else s[key].astype(dtype))
        np.save(d / "segment20.npy", s["segment"].astype(np.int16))
        np.save(d / "instance.npy", s["instance"].astype(np.int16))


@pytest.mark.parametrize("seed", [0, 1])
def test_sonata_config_pipeline_matches_jax(tmp_path, seed):
    """The config's train pipeline on a ScanNet-layout scene: every array of
    the JAX package's bit for bit, and the same draws. The offsets differ by
    design: the port keeps one a view (JAX's Collect sums them into one)."""
    _write_scannet(tmp_path, (0,))
    options = {"data.train.data_root": str(tmp_path)}
    got_cfg, want_cfg = Config.fromfile(SONATA), JaxConfig.fromfile(SONATA)
    got_cfg.merge_from_dict(options)
    want_cfg.merge_from_dict(options)
    outs = []
    for build, cfg in ((build_dataset, got_cfg), (jax_build_dataset, want_cfg)):
        np.random.seed(seed)
        random.seed(seed)
        outs.append((build(dict(cfg.data.train))[0], _rng_state()))
    (got, got_state), (want, want_state) = outs
    _assert_same(got, want, skip=("global_offset", "local_offset"))
    np.testing.assert_array_equal(got_state[0], want_state[0])
    assert got_state[1:] == want_state[1:]
    for prefix, views in (("global", 2), ("local", 4)):
        offset = got[f"{prefix}_offset"]
        assert len(offset) == views and offset[-1] == want[f"{prefix}_offset"][-1] == len(got[f"{prefix}_coord"])
    assert got["global_feat"].shape[1] == 6 and len(got["global_coord"]) <= 2 * 65536


@pytest.mark.parametrize("mix_prob,capacity", [(0.0, None), (1.0, None), (0.0, 3000)],
                         ids=["padded", "mix3d", "subsampled"])
def test_multiview_collate_matches_jax(mix_prob, capacity):
    samples = _samples(Compose(PIPELINE))
    jax_samples = _samples(JaxCompose(PIPELINE))
    for a, b in zip(samples, jax_samples):
        _assert_same(a, b)
    need = max(sum(int(s[f"{p}_offset"][-1]) for s in samples) for p in ("global", "local"))
    cap = capacity or need + 256
    outs = []
    for collate, batch in ((point_collate_fn, samples), (jax_point_collate_fn, jax_samples)):
        np.random.seed(7)
        random.seed(7)
        outs.append(collate(copy.deepcopy(batch), mix_prob=mix_prob, capacity=cap))
    got, want = outs
    dropped = got.pop("dropped")
    _assert_same(got, want)
    assert (dropped > 0) == (capacity is not None)
    if capacity is None:
        assert sorted(np.unique(got["global_batch"]))[1:] == list(range(2 if mix_prob else 4))
        assert sorted(np.unique(got["local_batch"]))[1:] == list(range(4 if mix_prob else 8))
        with pytest.raises(ValueError, match="> capacity"):
            point_collate_fn(copy.deepcopy(samples), capacity=need // 2, drop_overflow=False)


# ------------------------------------------------------------ model pieces


def _jax_trees(sd: dict):
    """The port's Sonata tensors (by name) -> JAX Sonata params and
    batch_stats trees: the JAX converter for the backbones, the heads by
    hand."""
    tree, stats = {}, {}
    for root, prefix in SONATA_ROOTS.items():
        if prefix.endswith("backbone"):
            sub = {"backbone." + k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}
            params, bs, unmatched = convert_ptv3(sub)
            assert unmatched == []
            tree[root], stats[root] = params["backbone_module"], bs.get("backbone_module", {})
        else:
            tree[root] = {
                "Dense_0": {"kernel": sd[f"{prefix}.mlp.0.weight"].T, "bias": sd[f"{prefix}.mlp.0.bias"]},
                "Dense_1": {"kernel": sd[f"{prefix}.mlp.2.weight"].T, "bias": sd[f"{prefix}.mlp.2.bias"]},
                "prototypes": sd[f"{prefix}.prototype.weight_v"].T,
            }
    return tree, stats


@pytest.fixture(scope="module")
def views():
    """A two-scene multi-view batch (both packages' collate agree above),
    Sonata at test width with the port's random weights as JAX trees, the
    teacher a perturbed copy of the student, random running statistics."""
    samples = _samples(Compose(PIPELINE))
    need = max(sum(int(s[f"{p}_offset"][-1]) for s in samples) for p in ("global", "local"))
    arrays = point_collate_fn(samples, capacity=-(-need // 256) * 256)
    assert arrays.pop("dropped") == 0
    num_scenes = arrays.pop("num_scenes")
    jin = jax_view_inputs({k: jnp.asarray(v) for k, v in arrays.items()}, num_scenes)
    model = jax_build_model(SONATA_MODEL)
    params, stats = _jax_trees({k: v.numpy() for k, v in build_model(SONATA_MODEL, device="cpu").state_dict().items()})
    rs = np.random.RandomState(5)
    for teacher, student in model.ema_pairs.items():
        params[teacher] = jax.tree_util.tree_map(
            lambda x: x + rs.randn(*x.shape).astype(np.float32) * 0.01 * (np.abs(x).max() + 1e-3), params[student])
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5, stats)
    arrays["num_scenes"] = num_scenes
    return dict(arrays=arrays, jin=jin, model=model, params=params, stats=stats, num_scenes=num_scenes)


def _port_model(views):
    model = build_model(SONATA_MODEL, device="cpu")
    model.load_state_dict(params_from_jax(views["params"], views["stats"]), strict=True)
    return model


def _jax_backbone(views, sd, amp=False):
    """The JAX backbone's forward on the port's weights `sd`: (out, skips),
    in train mode, with the mask token on a third of the points."""
    model = jax_build_model(dict(BACKBONE, amp=amp))
    pb = views["jin"]["global"].replace(num_scenes=2 * views["num_scenes"],
                                        origin_coord=views["jin"]["global_origin_coord"])
    params, stats, unmatched = convert_ptv3({f"backbone.{k}": v.numpy() for k, v in sd.items()})
    assert unmatched == []
    variables = {"params": params["backbone_module"], "batch_stats": stats["backbone_module"]}
    mask = jnp.asarray(np.random.RandomState(3).rand(pb.capacity) < 0.3) & pb.mask
    fn = jax.jit(lambda v, pb, mask: model.apply(v, pb, train=True, patch_mask=mask, mutable=["batch_stats"])[0])
    out, skips = fn(variables, pb, mask)
    return out, skips, np.asarray(mask)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_ptv3m2_encoder_matches_jax(views, amp):
    """enc_mode features, and every skip's features, clusters and pooled
    origin coordinates, with the mask token on a third of the points and
    LayerScale 1e-5 (f32 < 1e-2 relative, AMP 5e-2: the PTv3 bounds)."""
    model = build_model(dict(BACKBONE, amp=amp), device="cpu", generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for name, p in model.named_parameters():  # LayerScale and the mask token off their init
            if name.endswith(("gamma", "mask_token")):
                p.add_(torch.rand(p.shape, generator=torch.Generator().manual_seed(3)) * 1e-5)
    want_out, want_skips, mask = _jax_backbone(views, model.state_dict(), amp)
    mask = np.array(mask)
    model.train()
    pb = make_view_inputs(views["arrays"], views["num_scenes"], device="cpu")["global"]
    pb = pb.replace(num_scenes=2 * views["num_scenes"])
    out, diag, skips = model(pb, generator=torch.Generator(), patch_mask=torch.as_tensor(mask))
    bound = 5e-2 if amp else 1e-2
    assert _rel(out.feat.float().detach().numpy(), np.asarray(want_out.feat, np.float32)) < bound
    assert len(skips) == len(want_skips) == 2
    for (spb, cluster, _), (wpb, wcluster, _) in zip(skips, want_skips):
        np.testing.assert_array_equal(cluster.numpy(), np.asarray(wcluster))
        np.testing.assert_array_equal(spb.batch.numpy(), np.asarray(wpb.batch))
        np.testing.assert_allclose(spb.origin_coord.numpy(), np.asarray(wpb.origin_coord), rtol=1e-6, atol=1e-6)
        assert _rel(spb.feat.float().detach().numpy(), np.asarray(wpb.feat, np.float32)) < bound
    assert all(int(v) == 0 for vs in diag.values() for v in vs)
    # the mask token takes the masked points' place: without it they differ
    plain, _, _ = model(pb, generator=torch.Generator())
    assert not torch.equal(plain.feat, out.feat)


def test_ptv3m2_scratch_config_logits_match_jax():
    """`semseg-pt-v3m2-0-sonata-scratch.py`'s segmentor (linear stem, decoder,
    the block engine) at test width, eval forward: logits < 1e-2 relative."""
    cfg = Config.fromfile(SCRATCH).model
    small = dict(enc_depths=(1, 1), enc_channels=(16, 32), enc_num_head=(1, 2), enc_patch_size=(64,) * 2,
                 dec_depths=(1,), dec_channels=(32,), dec_num_head=(2,), dec_patch_size=(64,), stride=(2,),
                 order=("z", "hilbert"), serialize_depth=8, pool_capacity_factors=(0.5,),
                 block_engine_min_points=2048, block_capacity_factor=1 / 16)
    model_cfg = dict(cfg, backbone=dict(cfg.backbone, **small), backbone_out_channels=32, num_classes=5)
    model_cfg.pop("criteria")
    grid, feat = _surface_scene(span=50, seed=3, keep=0.5)
    n = len(grid)
    cap = -(-n // 256) * 256
    arrays = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                  grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32))
    arrays["coord"][:n], arrays["feat"][:n], arrays["grid_coord"][:n], arrays["batch"][:n] = grid * 0.02, feat, grid, 0
    model = build_model(model_cfg, device="cpu")  # its random weights, through the JAX converter
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, unmatched = convert_ptv3(sd)
    assert unmatched == [] and "stem_linear" in params["backbone_module"]["embedding"]
    back = params_from_jax(params, stats)
    assert all(np.array_equal(back[k].numpy(), v) for k, v in sd.items())
    jmodel = jax_build_model(model_cfg)
    jpb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jpb)["seg_logits"])
    res = model(make_point_batch(arrays, 1, device="cpu"))
    valid = arrays["batch"] >= 0
    assert _rel(res["seg_logits"].numpy()[valid], want[valid]) < 1e-2
    assert sum(int(v) for vs in res["diagnostics"].values() for v in vs) == 0
    assert len(res["diagnostics"]["block_overflow"]) >= 1  # the block engine ran


def test_online_cluster_and_sinkhorn_match_jax():
    rs = np.random.RandomState(0)
    feat = rs.randn(300, 24).astype(np.float32)
    head = JaxOnlineCluster(32, 16, 40)
    variables = head.init(jax.random.PRNGKey(0), jnp.asarray(feat))
    want = np.asarray(head.apply(variables, jnp.asarray(feat)))
    port = OnlineCluster(24, 32, 16, 40)
    p = jax.tree_util.tree_map(np.array, variables["params"])
    with torch.no_grad():
        port.mlp[0].weight.copy_(torch.as_tensor(p["Dense_0"]["kernel"].T))
        port.mlp[0].bias.copy_(torch.as_tensor(p["Dense_0"]["bias"]))
        port.mlp[2].weight.copy_(torch.as_tensor(p["Dense_1"]["kernel"].T))
        port.mlp[2].bias.copy_(torch.as_tensor(p["Dense_1"]["bias"]))
        port.prototype.weight_v.copy_(torch.as_tensor(p["prototypes"].T))
        got = port(torch.as_tensor(feat)).numpy()
    assert _rel(got, want) < 1e-5
    valid = rs.rand(300) < 0.7
    for temp in (0.04, 0.07):
        want_q = np.asarray(jax_sinkhorn(jnp.asarray(want), temp, jnp.asarray(valid)))
        got_q = sinkhorn_knopp(torch.as_tensor(want), temp, torch.as_tensor(valid)).numpy()
        assert _rel(got_q, want_q) < 1e-5
        np.testing.assert_array_equal(got_q[~valid], 0.0)
        np.testing.assert_allclose(got_q[valid].sum(1), 1.0, rtol=1e-4)
    with pytest.raises(NotImplementedError):
        sinkhorn_knopp(torch.as_tensor(want), 0.05, torch.as_tensor(valid), sync_axis="data")


def test_knn_query_matches_jax():
    """Indices equal wherever the nearest is clear of the second by 1e-6
    (exact distances), distances 1e-5; padding never matches; chunked over
    the queries."""
    rs = np.random.RandomState(0)
    base = rs.rand(3000, 3).astype(np.float32) * 3
    query = rs.rand(2000, 3).astype(np.float32) * 3
    bb = np.where(rs.rand(3000) < 0.1, -1, rs.randint(0, 3, 3000)).astype(np.int32)
    qb = np.where(rs.rand(2000) < 0.1, -2, rs.randint(0, 4, 2000)).astype(np.int32)  # scene 3: no base
    for k in (1, 3):
        wi, wd = map(np.asarray, jax_knn(k, jnp.asarray(base), jnp.asarray(bb), jnp.asarray(query), jnp.asarray(qb)))
        gi, gd = knn_query(k, torch.as_tensor(base), torch.as_tensor(bb), torch.as_tensor(query),
                           torch.as_tensor(qb), chunk=512)
        gi, gd = gi.numpy(), gd.numpy()
        exact = np.sqrt(((query[:, None, :].astype(np.float64) - base[None].astype(np.float64)) ** 2).sum(-1))
        exact = np.where((qb[:, None] == bb[None]) & (bb[None] >= 0), exact, np.inf)
        srt = np.sort(exact, axis=1)
        with np.errstate(invalid="ignore"):
            clear = (srt[:, k] - srt[:, k - 1] > 1e-6) | ~np.isfinite(srt[:, 0])
        np.testing.assert_array_equal(gi[clear], wi[clear])
        np.testing.assert_allclose(gd, wd, rtol=1e-5)
        none = ~np.isfinite(srt[:, 0])
        assert none.sum() > 100 and (gi[none] == 0).all() and (gd[none] == np.sqrt(1e10)).all()
        found = np.isfinite(srt[:, 0])
        np.testing.assert_allclose(gd[found, 0], srt[found, 0], rtol=1e-4, atol=1e-6)


def _jax_mask(views, size, ratio, key):
    model, variables = views["model"], {"params": views["params"], "batch_stats": views["stats"]}
    g = views["jin"]["global"].replace(num_scenes=2 * views["num_scenes"])
    mask, cluster = model.apply(variables, g, views["jin"]["global_origin_coord"], jnp.float32(size),
                                jnp.float32(ratio), key, method=lambda m, *a: m.generate_mask(*a))
    return np.asarray(mask), np.asarray(cluster)


def _patch_scores(draw, cluster):
    """JAX's draw with every score past the P patches raised above all of
    them: JAX's rank among all N scores then equals the rank among the first
    P, which the port (and the reference) take."""
    n = len(draw)
    patches = int(cluster[cluster < n].max()) + 1
    return np.where(np.arange(n) < patches, draw, np.float32(2.0)).astype(np.float32)


def test_generate_mask_matches_jax(views, monkeypatch):
    """Patches (the z-order runs of the mask grid) bit-equal to JAX's; on
    JAX's own draw JAX masks a few of them (it ranks each patch's score
    among all N, fault of `sonata.py:157-159`), the port `mask_ratio` of
    them; on the draw with the scores past the patches raised, both packages
    give the same mask bit for bit."""
    port = _port_model(views)
    pb = make_view_inputs(views["arrays"], views["num_scenes"], device="cpu")["global"]
    pb = pb.replace(num_scenes=2 * views["num_scenes"])
    valid = int(pb.mask.sum())
    uniform = jax.random.uniform
    for size, ratio, seed in ((0.3, 0.5, 1), (0.1, 0.7, 2), (0.4, 0.3, 3)):
        key = jax.random.PRNGKey(seed)
        want, want_cluster = _jax_mask(views, size, ratio, key)
        draw = np.asarray(uniform(key, (pb.capacity,)))
        got, cluster = port.generate_mask(pb, pb.origin_coord, size, ratio, torch.as_tensor(draw))
        np.testing.assert_array_equal(cluster.numpy(), want_cluster)
        patches = int(want_cluster[want_cluster < pb.capacity].max()) + 1
        rank_all = np.argsort(np.argsort(draw, kind="stable"), kind="stable")[:patches]
        rank_patches = np.argsort(np.argsort(draw[:patches], kind="stable"), kind="stable")
        jax_tag, tag = rank_all < ratio * patches, rank_patches < ratio * patches
        np.testing.assert_array_equal(want, jax_tag[np.minimum(want_cluster, patches - 1)] & pb.mask.numpy())
        np.testing.assert_array_equal(got.numpy(), tag[np.minimum(want_cluster, patches - 1)] & pb.mask.numpy())
        assert tag.sum() == np.ceil(ratio * patches) > jax_tag.sum()
        crafted = _patch_scores(draw, want_cluster)
        monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(crafted))
        want, _ = _jax_mask(views, size, ratio, key)
        monkeypatch.setattr(jax.random, "uniform", uniform)
        np.testing.assert_array_equal(got.numpy(), want)
        assert abs(float(got.sum()) / valid - ratio) < 0.3


# ------------------------------------------------------------ the train step


def _jax_sonata_step(views, monkeypatch):
    """One JAX Sonata step's losses, gradients and running statistics; its
    mask scores are `_patch_scores` of a draw, which the port gets too."""
    model = views["model"]
    key = jax.random.PRNGKey(11)
    hyper = {k: jnp.float32(v) for k, v in HYPER.items()}
    n = views["arrays"]["global_coord"].shape[0]
    _, cluster = _jax_mask(views, HYPER["mask_size"], HYPER["mask_ratio"], key)
    scores = _patch_scores(np.random.RandomState(4).rand(n).astype(np.float32), cluster)
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(scores))

    def loss_fn(params):
        out, upd = model.apply({"params": params, "batch_stats": views["stats"]}, views["jin"], train=True,
                               hyper=hyper, rngs={"mask": key}, mutable=["batch_stats", "diagnostics"])
        return out["loss"], ({k: out[k] for k in LOSSES}, upd["batch_stats"])

    (loss, (parts, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(views["params"])
    monkeypatch.undo()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(loss=float(loss), parts={k: float(v) for k, v in parts.items()}, grads=tree(grads),
                stats=tree(stats), scores=scores)


def test_train_step_matches_jax(views, monkeypatch):
    """One Sonata step (the same mask scores on both sides, hyperparameters
    as SonataHook hands them): each loss, every student gradient; then the
    update (JAX's masked AdamW applied to the port's gradients gives the
    port's new student to 1e-6, the teacher untouched by it) and the EMA
    (teacher = m * teacher + (1 - m) * new student, to 1e-6)."""
    want = _jax_sonata_step(views, monkeypatch)
    model = _port_model(views)
    scores = torch.as_tensor(want["scores"])
    forward = model.forward
    model.forward = lambda data, generator=None, hyper=None: forward(data, generator, hyper, mask_scores=scores)
    optimizer = build_optimizer(OPTIMIZER, model)
    step = build_train_step(model, optimizer, build_scheduler(SCHEDULER, optimizer, total_steps=100))
    momentum = 0.996
    res = step(make_view_inputs(views["arrays"], views["num_scenes"], device="cpu"), torch.Generator(),
               dict(HYPER, momentum=momentum))
    b = BOUND
    for name in LOSSES + ("loss",):
        got, ref = float(res[name]), want["parts"].get(name, want["loss"])
        assert np.isfinite(got) and abs(got - ref) / abs(ref) < b["loss"], (name, got, ref)
    assert int(res["pool_overflow"]) == 0
    jgrads = {n: g.numpy() for n, g in params_from_jax(want["grads"], {}).items()}
    # biases that feed only train-mode BatchNorms have zero gradient in exact
    # arithmetic: both sides hold rounding noise there, held against the
    # largest gradient (as tests/test_torch_port_train.py)
    gmax = max(np.abs(p.grad.numpy()).max() for p in model.student.parameters())
    bad = {}
    for name, p in model.student.named_parameters():
        g, w = p.grad.numpy(), jgrads[f"student.{name}"]
        if max(np.abs(g).max(), np.abs(w).max()) < 1e-3 * gmax and name.endswith("down.proj.bias"):
            continue
        err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        if not (err < b["grad"] and _cos(g, w) > b["cos"]):
            bad[name] = (err, _cos(g, w))
    assert not bad, bad
    assert all(p.grad is None for p in model.teacher.parameters())

    grads = {f"student.{n}": p.grad.numpy() for n, p in model.student.named_parameters()}
    grads.update({f"teacher.{n}": np.zeros(tuple(p.shape), np.float32) for n, p in model.teacher.named_parameters()})
    tx = jax_build_optimizer(OPTIMIZER, views["params"], jax_build_scheduler(SCHEDULER, total_steps=100))
    tx = optax.masked(tx, lambda t: {k: jax.tree_util.tree_map(lambda _: not k.startswith("teacher"), v)
                                     for k, v in t.items()})
    updates, _ = tx.update(_jax_trees(grads)[0], tx.init(views["params"]), views["params"])
    new = dict(optax.apply_updates(views["params"], updates))
    for teacher, student in views["model"].ema_pairs.items():
        new[teacher] = jax.tree_util.tree_map(lambda t, s: momentum * t + (1 - momentum) * s, new[teacher],
                                              new[student])
    want_sd = params_from_jax(jax.tree_util.tree_map(np.asarray, new), want["stats"])
    sd = model.state_dict()
    before = params_from_jax(views["params"], views["stats"])
    for name, _ in model.named_parameters():
        np.testing.assert_allclose(sd[name].numpy(), want_sd[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
        assert not torch.equal(sd[name], before[name]) or name.endswith("mask_token"), name
    # running statistics: the teacher's from its forward, the student's from two
    for name in sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), want_sd[name].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=name)


def test_ema_update_is_the_formula():
    model = build_model(SONATA_MODEL, device="cpu")
    t0 = {n: p.detach().clone() for n, p in model.teacher.named_parameters()}
    assert all(torch.equal(t0[n], p) for n, p in model.student.named_parameters())
    assert not any(p.requires_grad for p in model.teacher.parameters())
    with torch.no_grad():
        for p in model.student.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(0)))
    model.ema_update(0.9)
    for n, p in model.student.named_parameters():
        assert torch.equal(model.teacher.get_parameter(n), (0.9 * t0[n]) + ((1.0 - 0.9) * p)), n


# ------------------------------------------------------------ hooks


def _fake_trainer(model, steps, max_epoch, start_epoch=0):
    return SimpleNamespace(model=model, train_loader=[None] * steps, max_epoch=max_epoch, start_epoch=start_epoch,
                           comm_info={}, storage=None, epoch=0)


class _Storage:
    def __init__(self):
        self.rows = {}

    def put_scalar(self, name, value, smoothing_hint=True):
        self.rows.setdefault(name, []).append(value)


@pytest.mark.parametrize("start_epoch", [0, 2])
def test_sonata_hook_matches_jax_scheduler(start_epoch):
    """Every step of a 3-epoch run of 7 steps (warm-ups of 1 step), and a
    run resumed at epoch 2: the JAX hook's values, each from JAX's
    `CosineScheduler`."""
    params = dict(mask_size_start=0.1, mask_size_base=0.4, mask_size_warmup_ratio=0.05, mask_ratio_start=0.3,
                  mask_ratio_base=0.7, mask_ratio_warmup_ratio=0.2, teacher_temp_start=0.04,
                  teacher_temp_base=0.07, teacher_temp_warmup_ratio=0.1, momentum_base=0.996, momentum_final=1.0)
    model = SimpleNamespace(**params)
    runs = []
    for hook_cls in (SonataHook, JaxSonataHook):
        hook = hook_cls()
        hook.trainer = _fake_trainer(model, 7, 3, start_epoch)
        if hook_cls is SonataHook:
            hook.trainer.storage = _Storage()
        hook.before_train()
        values = []
        for _ in range((3 - start_epoch) * 7):
            hook.before_step()
            values.append({k: float(v) for k, v in hook.trainer.comm_info["model_hyper"].items()})
        runs.append(values)
    got, want = runs
    assert got == want and len(got) == (3 - start_epoch) * 7
    total = 21
    sched = JaxCosineScheduler(0.07, 0.07, total, int(total * 0.1), 0.04)
    assert [v["teacher_temp"] for v in got] == [float(sched[i]) for i in range(start_epoch * 7, total)]
    assert got[-1]["momentum"] < 1.0 and got[0]["momentum"] >= 0.996
    port = CosineScheduler(0.4, 0.4, total, 1, 0.1)
    np.testing.assert_array_equal(port.schedule, JaxCosineScheduler(0.4, 0.4, total, 1, 0.1).schedule)


def test_weight_decay_hook_sets_every_group():
    model = build_model(SONATA_MODEL, device="cpu")
    optimizer = build_optimizer(OPTIMIZER, model, [dict(keyword="enc0.", lr=0.001)])
    hook = WeightDecaySchedular(base_value=0.04, final_value=0.2)
    hook.trainer = SimpleNamespace(optimizer=optimizer, max_epoch=4, epoch=0, storage=_Storage(),
                                   logger=SimpleNamespace(info=lambda *a: None))
    for epoch in range(4):
        hook.trainer.epoch = epoch
        hook.before_epoch()
        want = 0.2 + 0.5 * (0.04 - 0.2) * (1 + np.cos(np.pi * epoch / 4))
        assert [g["weight_decay"] for g in optimizer.param_groups] == [want, want]
    assert hook.trainer.storage.rows["params/weight_decay"][0] == pytest.approx(0.04)
    names = {n for g in optimizer.param_groups for n in g["names"]}
    assert names and not any(n.startswith("teacher.") for n in names)


# ------------------------------------------------------------ the trainer


TINY_SONATA = """
_base_ = [{base!r}]
batch_size = 2
num_worker = 0
enable_amp = False
point_capacity = 4096
host_geometry = False
model = dict(_delete_=True, **{model!r})
epoch = 2
eval_epoch = 2
optimizer = dict(_delete_=True, type="AdamW", lr=0.004, weight_decay=0.04)
scheduler = dict(_delete_=True, type="OneCycleLR", max_lr=0.004, pct_start=0.05, anneal_strategy="cos",
                 div_factor=10.0, final_div_factor=1000.0)
param_dicts = None
data = dict(_delete_=True, num_classes=20, ignore_index=-1, names=["no-category"],
            train=dict(type="ScanNetDataset", split="train", data_root={root!r}, transform={pipeline!r},
                       test_mode=False))
hooks = {hooks!r}
"""
# mask ratio 0: JAX draws its mask scores from its own key, so the trainers
# can agree only where no patch is masked. One stage (the heads read stage
# 0): the trainers are under test here, the model in the step test above,
# and the JAX trainer compiles the model's init and its step
TRAINER_MODEL = dict(SONATA_MODEL, mask_ratio_start=0.0, mask_ratio_base=0.0, up_cast_level=0,
                     backbone=dict(SONATA_BACKBONE, stride=(), enc_depths=(1,), enc_channels=(16,),
                                   enc_num_head=(1,), enc_patch_size=(64,), pool_capacity_factors=()))
TRAINER_HOOKS = [dict(type="InformationWriter"), dict(type="SonataHook")]


def _tiny_config(tmp_path, hooks=TRAINER_HOOKS, model=TRAINER_MODEL):
    root = tmp_path / "scannet"
    if not root.exists():
        _write_scannet(root, (0, 1, 2, 3), n=1200)
    path = tmp_path / "tiny_sonata.py"
    path.write_text(TINY_SONATA.format(base=SONATA, model=model, root=str(root), pipeline=PIPELINE, hooks=hooks))
    return str(path)


def _losses(save_path):
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_matches_jax(tmp_path):
    """The port's trainer against the JAX trainer (one-device mesh) from the
    same initial weights, 2 epochs of 2 steps, without WeightDecaySchedular
    (the JAX one breaks the teacher mask): every loss within 2e-2."""
    path = _tiny_config(tmp_path)
    options = dict(seed=0, save_path=str(tmp_path / "jax"))
    jcfg = jax_setup(jax_config_parser(path, options))
    jcfg.hooks = [dict(type="SonataHook")]
    jt = OneDeviceJaxTrainer(jcfg)
    jt.losses = []
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    weights = params_from_jax(tree(dict(jt.state.params)), tree(jt.state.batch_stats))
    jt.train()
    cfg = default_setup(default_config_parser(path, dict(options, save_path=str(tmp_path / "port"))))
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(weights, strict=True)
    trainer.train()
    rows = _losses(tmp_path / "port")
    got = [r["loss"] for r in rows]
    assert len(got) == len(jt.losses) == 4
    np.testing.assert_allclose(got, jt.losses, rtol=2e-2)
    for r in rows:
        assert r["params/mask_ratio"] == 0.0 and all(np.isfinite(r[k]) for k in LOSSES)
        assert r["collate_dropped"] == 0 and r["pool_overflow"] == 0


RESUME_HOOKS = [dict(type="CheckpointLoader"), dict(type="InformationWriter"), dict(type="SonataHook"),
                dict(type="WeightDecaySchedular", base_value=0.04, final_value=0.2),
                dict(type="CheckpointSaver", save_freq=1)]
RESUME_MODEL = dict(SONATA_MODEL, backbone=dict(SONATA_BACKBONE, drop_path=0.1, shuffle_orders=True))


def test_resume_equals_straight_run(tmp_path):
    """The config's randomness (masks, order shuffles, drop path) and hooks:
    two epochs straight against the second resumed from `epoch_1.pth`, which
    holds the teacher: the same losses and every tensor, bit for bit."""
    path = _tiny_config(tmp_path, RESUME_HOOKS, RESUME_MODEL)
    straight = main_worker(default_config_parser(path, dict(seed=0, save_path=str(tmp_path / "a"))), device="cpu")
    ckpt = torch.load(tmp_path / "a" / "model" / "epoch_1.pth", weights_only=False)
    assert any(k.startswith("teacher.backbone.") for k in ckpt["state_dict"])
    resumed = main_worker(default_config_parser(path, dict(seed=0, save_path=str(tmp_path / "b"), resume=True,
                                                           weight=str(tmp_path / "a/model/epoch_1.pth"))),
                          device="cpu")
    first, second = _losses(tmp_path / "a"), _losses(tmp_path / "b")
    assert [r["epoch"] for r in first] == [1, 1, 2, 2]
    keys = ("loss",) + LOSSES + ("params/mask_size", "params/mask_ratio", "params/momentum")
    assert [[r[k] for k in keys] for r in second] == [[r[k] for k in keys] for r in first[2:]]
    assert second[0]["params/weight_decay"] == first[2]["params/weight_decay"] != first[0]["params/weight_decay"]
    for (name, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert straight.optimizer.param_groups[0]["weight_decay"] == pytest.approx(0.12)


# ------------------------------------------------------------ the rest


def test_params_from_jax_round_trips(views):
    """JAX Sonata trees -> the port's names -> JAX trees again, exactly; and
    PT-v3m2's backbone through the JAX converter."""
    sd = {k: v.numpy() for k, v in params_from_jax(views["params"], views["stats"]).items()}
    model = build_model(SONATA_MODEL, device="cpu")
    assert set(sd) == set(model.state_dict())
    back, back_stats = _jax_trees(sd)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t)}
    got, want = flat(back), flat(views["params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "student.backbone.enc.enc1.block0.ls2.0.gamma" in sd
    assert "student.backbone.embedding.mask_token" in sd and "teacher.mask_head.prototype.weight_g" in sd


# PT-v3m3 (RoPE), the up-cast of DefaultSegmentorV2 and LoRA are ported
# (tests/test_torch_port_utonia.py, tests/test_torch_port_probe.py,
# tests/test_torch_port_lora.py), and PDNorm (tests/test_torch_port_ppt.py);
# their cases hold what of them is not: PT-v3m3's attention dropout and the
# up-cast segmentor's projection dropout (RPE is ported: tests/test_torch_port_rpe.py)
@pytest.mark.parametrize("cfg", [dict(type="Sonata-v1m2", backbone=BACKBONE), dict(type="Sonata-v1m3"),
                                 dict(BACKBONE, type="PT-v3m3", enc_channels=(18, 18, 36), attn_drop=0.1),
                                 dict(BACKBONE, type="PT-v3m2", rope_base=1e4),
                                 dict(SONATA_MODEL, sync_axis="data"), dict(SONATA_MODEL, mask_jitter=0.01),
                                 dict(type="DefaultSegmentorV2", backbone=dict(BACKBONE, proj_drop=0.1),
                                      up_cast_level=2)],
                         ids=["sonata-v1m2", "sonata-v1m3", "pt-v3m3", "rope", "sync_axis", "mask_jitter",
                              "up_cast_segmentor"])
def test_unported_raise(cfg):
    with pytest.raises(NotImplementedError):
        MODELS.build(cfg)


def test_head_in_channels_from_the_backbone():
    """The ScanNet pretraining config says 1,232; up_cast gives 384 + 512 + 192."""
    cfg = Config.fromfile(SONATA).model
    assert cfg.head_in_channels == 1232
    small = dict(cfg.backbone, enc_depths=(1,) * 5)
    model = MODELS.build(dict(cfg, backbone=small, head_hidden_channels=8, head_embed_channels=8,
                              head_num_prototypes=8))
    assert model.head_in_channels == 1088 and model.student["mask_head"].mlp[0].in_features == 1088
    with pytest.raises(ValueError, match="1232"):
        MODELS.build(dict(cfg, backbone=small, strict_head_in_channels=True))
    with pytest.raises(ValueError, match="enc_mode"):
        MODELS.build(dict(SONATA_MODEL, backbone=dict(BACKBONE, enc_mode=False)))


def test_trainer_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the trainer would run on it")
    cfg = default_setup(default_config_parser(_tiny_config(tmp_path), dict(save_path=str(tmp_path / "a"))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
