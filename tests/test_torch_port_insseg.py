"""Instance segmentation in the port against the JAX package, on the CPU.

`InstanceParser`, the padding of ``instance`` / ``instance_centroid`` and
Mix3D's instance offset (bit for bit); `bfs_cluster` (the port's own C++,
built with g++) against the JAX package's native one (identical ids);
PG-v1m1 over a small SpUNet-v1m1 and PG-v1m2 over a small PT-v3m1 (the
sorted layout on) with `params_from_jax`: the eval outputs, the three
losses and one train step's gradients; `propose_instances`,
`evaluate_scene` + `aggregate_ap` and `write_submission` on the same numpy
inputs (equal exactly); `InsSegEvaluator` and `InsSegTester` through a
tiny config; and the JAX-side faults this slice does not copy, each named
by a test of its own.

Small models: SpUNet at widths 8-24 on a ~4,200-point surface scene, PT-v3m1
at 32-128 (head dim 16, patch 128, the gather engine) on the same scene.
"""

import copy
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

from pointcept_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pointcept_tpu.datasets import utils as jutils  # noqa: E402
from pointcept_tpu.datasets.transform import TRANSFORMS as JAX_TRANSFORMS  # noqa: E402
from pointcept_tpu.engines.test import TESTERS as JAX_TESTERS  # noqa: E402
from pointcept_tpu.engines.test import InsSegTester as JaxInsSegTester  # noqa: E402
from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.models.utils.convert import convert_state_dict  # noqa: E402
from pointcept_tpu.ops.clustering import bfs_cluster as jax_bfs_cluster  # noqa: E402
from pointcept_tpu.utils import instance_eval as jeval  # noqa: E402
from pointcept_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_tpu.utils.optimizer import build_optimizer as jax_build_optimizer  # noqa: E402
from pointcept_tpu.utils.scheduler import build_scheduler as jax_build_scheduler  # noqa: E402
from pointcept_tpu_torch.datasets import TRANSFORMS, synthesize_scene  # noqa: E402
from pointcept_tpu_torch.datasets import utils as tutils  # noqa: E402
from pointcept_tpu_torch.engines import InsSegTester, build_train_step, make_point_batch  # noqa: E402
from pointcept_tpu_torch.engines.hooks.evaluator import scene_records  # noqa: E402
from pointcept_tpu_torch.engines.train import check_conditions  # noqa: E402
from pointcept_tpu_torch.models import MODELS, apply_amp_policy, build_model  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import PG_HEADS, params_from_jax  # noqa: E402
from pointcept_tpu_torch.models.utils.structure import PointBatch  # noqa: E402
from pointcept_tpu_torch.ops.clustering import bfs_cluster, bfs_cluster_plain  # noqa: E402
from pointcept_tpu_torch.utils import build_optimizer, build_scheduler  # noqa: E402
from pointcept_tpu_torch.utils import instance_eval as teval  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
IGNORE = (-1, 0, 1)
OPTIMIZER = dict(type="AdamW", lr=0.006, weight_decay=0.05)
SCHEDULER = dict(type="OneCycleLR", max_lr=0.006, pct_start=0.05, anneal_strategy="cos", div_factor=10.0,
                 final_div_factor=1000.0)
SPUNET = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
              channels=(8, 16, 32, 64, 64, 32, 24, 24), layers=(1,) * 8, serialize_depth=8)
PTV3 = dict(type="PT-v3m1", in_channels=6, order=("z", "z-trans", "hilbert", "hilbert-trans"), stride=(2, 2),
            enc_depths=(1, 1, 1), enc_channels=(32, 64, 128), enc_num_head=(2, 4, 8), enc_patch_size=(128,) * 3,
            dec_depths=(1, 1), dec_channels=(32, 64), dec_num_head=(2, 4), dec_patch_size=(128,) * 2, mlp_ratio=2,
            drop_path=0.0, shuffle_orders=False, serialize_depth=7, pool_capacity_factors=(0.5, 0.5),
            conv_engine="gather")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cos(got, want):
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


# ------------------------------------------------------------ data


def _raw_scene(seed, points=6000, extent=2.0):
    sc = synthesize_scene(seed, num_points=points, num_classes=20, extent=extent)
    sc["color"] = sc["color"].astype(np.uint8).astype(np.float32)
    return sc


def test_instance_parser_matches_jax():
    """The renumbered instances, the centroids (f32) and the boxes: bit for
    bit, ScanNet's ignore set and one without the floor."""
    for ignore in (IGNORE, (-1,)):
        sc = _raw_scene(3)
        got = TRANSFORMS.build(dict(type="InstanceParser", segment_ignore_index=ignore))(copy.deepcopy(sc))
        want = JAX_TRANSFORMS.build(dict(type="InstanceParser", segment_ignore_index=ignore))(copy.deepcopy(sc))
        for key in ("instance", "instance_centroid", "bbox"):
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
        # (with the floor kept, the raw -1 of the floor and walls is an instance id like any other)
        assert got["instance"].max() > 3 and (got["instance"] == -1).any() == (ignore == IGNORE)


def _parsed(seed):
    sc = _raw_scene(seed, points=3000)
    steps = [dict(type="GridSample", grid_size=0.02, hash_type="fnv", mode="train", return_grid_coord=True),
             dict(type="InstanceParser", segment_ignore_index=IGNORE),
             dict(type="Collect", keys=("coord", "grid_coord", "segment", "instance", "instance_centroid"),
                  feat_keys=("color", "normal"))]
    np.random.seed(seed)
    out = sc
    for t in steps:
        out = TRANSFORMS.build(t)(out)
    return out


@pytest.mark.parametrize("mix", [False, True])
def test_padding_and_mix3d_match_jax(mix):
    """`pad_to_point_batch` of a collated pair (centroids padded with -1.0),
    after Mix3D's instance offset or not: bit for bit."""
    samples = [_parsed(1), _parsed(2)]
    got_b, want_b = tutils.collate_fn(copy.deepcopy(samples)), jutils.collate_fn(copy.deepcopy(samples))
    if mix:
        got_b, want_b = tutils.mix3d(got_b), jutils.mix3d(want_b)
    cap = sum(s["coord"].shape[0] for s in samples) + 100
    got = tutils.pad_to_point_batch(got_b, cap, num_scenes=2)
    want = jutils.pad_to_point_batch(want_b, cap, num_scenes=2)
    for key in ("coord", "batch", "segment", "instance", "instance_centroid"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert (got["instance_centroid"][-100:] == -1.0).all()
    if mix:
        n0 = samples[0]["coord"].shape[0]
        first = samples[0]["instance"].max() + 1
        second = samples[1]["instance"]
        assert np.array_equal(got["instance"][n0 : n0 + len(second)], np.where(second != -1, second + first, -1))


def test_reorder_carries_instance_fields():
    """`PointBatch.reorder` permutes ``instance`` and ``instance_centroid``
    with every other per-point array."""
    rng = np.random.RandomState(0)
    n = 64
    pb = PointBatch(coord=torch.rand(n, 3), feat=torch.rand(n, 2), grid_coord=None,
                    batch=torch.zeros(n, dtype=torch.int32), segment=torch.arange(n, dtype=torch.int32),
                    instance=torch.from_numpy(rng.randint(-1, 5, n).astype(np.int32)),
                    instance_centroid=torch.rand(n, 3))
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32))
    inv = torch.argsort(perm).to(torch.int32)
    out = pb.reorder(perm, inv)
    p = perm.long()
    assert torch.equal(out.instance, pb.instance[p]) and torch.equal(out.instance_centroid, pb.instance_centroid[p])
    back = out.reorder(inv, perm)
    assert torch.equal(back.instance, pb.instance) and torch.equal(back.instance_centroid, pb.instance_centroid)


# ------------------------------------------------------------ clustering


def _blobs(seed, sizes, spread, labels, batches):
    rng = np.random.RandomState(seed)
    coords, lab, bat = [], [], []
    for i, size in enumerate(sizes):
        center = rng.uniform(-40, 40, 3)
        coords.append(center + rng.randn(size, 3) * spread)
        lab.append(np.full(size, labels[i % len(labels)]))
        bat.append(np.full(size, batches[i % len(batches)]))
    perm = rng.permutation(sum(sizes))
    return (np.concatenate(coords)[perm].astype(np.float32), np.concatenate(bat)[perm].astype(np.int32),
            np.concatenate(lab)[perm].astype(np.int32))


def _cap_sites(sites=6, crowd=10):
    """Sites where the neighbour cap decides the clusters: each site's first
    point P (the seed) has a crowd of points in the cell before its own
    (x - 1.45) and one point Q 1.45 past it, which only P reaches. With a
    cap under the crowd P adds crowd points only, and Q ends alone."""
    coords, rng = [], np.random.RandomState(3)
    for i in range(sites):
        o = np.array([10.0 * i + 1.4, 0.7, 0.7])
        crowd_pts = o + np.array([-1.45, 0.0, 0.0]) + rng.uniform(-0.02, 0.02, (crowd, 3)) * [0, 1, 1]
        coords += [o[None], crowd_pts, (o + [1.45, 0.0, 0.0])[None]]
    coords = np.concatenate(coords).astype(np.float32)
    n = len(coords)
    return coords, np.zeros(n, np.int32), np.zeros(n, np.int32)


BFS_CASES = {
    # the cap changes the clusters: each site's Q is cut off from its seed
    "cap_cuts": dict(points=_cap_sites, radius=1.5, min_points=3, cap=3),
    # dense blobs where every point has far more neighbours than the cap
    "cap_binds": dict(points=lambda: _blobs(7, (120, 300, 80, 200), 0.6, (2, 3), (0,)), radius=1.5, min_points=20,
                      cap=8),
    # small blobs under min_points: rejected, their points -1
    "rejected": dict(points=lambda: _blobs(7, (12, 300, 9, 150, 40, 5), 1.0, (4,), (0, 1)), radius=1.5,
                     min_points=30, cap=300),
    # labels and scenes interleaved in one region, negative coordinates
    "mixed": dict(points=lambda: _blobs(7, (400, 400, 250), 2.0, (2, 5, 7), (0, 1, 0)), radius=1.2, min_points=10,
                  cap=50),
}


@pytest.mark.parametrize("case", sorted(BFS_CASES))
def test_bfs_cluster_matches_jax(case):
    """The port's C++ against the JAX package's native library, and its
    numpy plain version: the same ids and counts."""
    c = BFS_CASES[case]
    coords, batch, labels = c["points"]()
    kw = dict(radius=c["radius"], min_points=c["min_points"], max_neighbors=c["cap"])
    got, num = bfs_cluster(coords, batch, labels, **kw)
    want, jnum = jax_bfs_cluster(coords, batch, labels, **kw)
    plain, pnum = bfs_cluster_plain(coords, batch, labels, **kw)
    assert num == jnum == pnum and num > 0
    assert np.array_equal(got, want) and np.array_equal(got, plain)
    if case in ("rejected", "cap_cuts"):
        assert (got == -1).any()
    if case == "cap_cuts":
        uncapped, _ = bfs_cluster(coords, batch, labels, **dict(kw, max_neighbors=300))
        assert (uncapped >= 0).all() and (got == -1).sum() == 6


def test_bfs_cluster_raises_without_its_library(monkeypatch, tmp_path):
    """Where its C++ does not build, `bfs_cluster` raises; nothing falls back
    to the plain version."""
    from pointcept_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build, "_host_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    coords, batch, labels = _blobs(1, (30,), 0.5, (0,), (0,))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        bfs_cluster(coords, batch, labels, radius=1.0)


# ------------------------------------------------------------ the models


def _instance_scene():
    """The SpUNet test's surface scene with instances: boxes of 15 voxels
    (the floor and walls, classes 1 and 0, carry none), each a class 2-12,
    centroids from the points."""
    grid, feat = _surface_scene(span=50, seed=3, keep=0.4)
    n = len(grid)
    cap = ((n + 255) // 256) * 256 + 256
    cell = grid // 15
    _, inst = np.unique(cell[:, 0] * 10000 + cell[:, 1] * 100 + cell[:, 2], return_inverse=True)
    seg = 2 + inst % 11
    floor, wall = grid[:, 2] == 0, (grid[:, 0] == 0) | (grid[:, 1] == 0)
    seg[wall], seg[floor] = 0, 1
    inst = np.where(floor | wall, -1, inst)
    coord = (grid * 0.02).astype(np.float32)
    centroid = np.full((n, 3), -1.0, np.float32)
    for i in np.unique(inst[inst >= 0]):
        centroid[inst == i] = coord[inst == i].mean(0)
    arrays = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                  grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32),
                  segment=np.full(cap, -1, np.int32), instance=np.full(cap, -1, np.int32),
                  instance_centroid=np.full((cap, 3), -1.0, np.float32))
    for key, value in dict(coord=coord, feat=feat, grid_coord=grid, batch=0, segment=seg, instance=inst,
                           instance_centroid=centroid).items():
        arrays[key][:n] = value
    return arrays


def _pg(kind, jax_unsorted=False, **extra):
    if kind == "spunet":
        return dict(type="PG-v1m1", backbone=SPUNET, backbone_out_channels=24, semantic_num_classes=13, **extra)
    backbone = dict(PTV3, sorted_layout=False) if jax_unsorted else PTV3
    return dict(type="PG-v1m2", backbone=backbone, backbone_out_channels=32, semantic_num_classes=13,
                criteria=[dict(type="CrossEntropyLoss", ignore_index=-1),
                          dict(type="LovaszLoss", mode="multiclass", ignore_index=-1)], **extra)


@pytest.fixture(scope="module")
def scene():
    arrays = _instance_scene()
    return dict(arrays=arrays, pb=jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1))


def _jax_weights(cfg: dict):
    """The port's seeded weights of `cfg` (running means moved by
    ±0.1, variances scaled by 1-1.5) as JAX trees: the backbone through the
    JAX package's converter, the heads by their names."""
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(5)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.numpy()
        if k.endswith("running_mean"):
            v = v + (rs.rand(*v.shape).astype(np.float32) - 0.5) * 0.2
        elif k.endswith("running_var"):
            v = v * (1 + rs.rand(*v.shape).astype(np.float32) * 0.5)
        sd[k] = v
    kind = "SpUNet-v1m1" if cfg["backbone"]["type"].startswith("SpUNet") else "PT-v3m1"
    params, stats, _ = convert_state_dict({k: v for k, v in sd.items() if k.startswith("backbone.")}, kind)
    for flax_name, name in dict(PG_HEADS, seg_head="seg_head").items():
        if name + ".running_mean" in sd:
            params[flax_name] = {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}
            stats[flax_name] = {"mean": sd[name + ".running_mean"], "var": sd[name + ".running_var"]}
        else:
            params[flax_name] = {"kernel": np.ascontiguousarray(sd[name + ".weight"].T), "bias": sd[name + ".bias"]}
    assert {k: v.numpy() for k, v in params_from_jax(params, stats).items()}.keys() == sd.keys()
    return params, stats


@pytest.fixture(scope="module", params=["spunet", "ptv3"])
def pg(request, scene):
    """The port's seeded weights in JAX's trees, the JAX eval outputs and
    one JAX train step's loss terms and gradients."""
    kind = request.param
    # the JAX PT-v3m1 cannot differentiate its sorted layout
    # (test_jax_sorted_layout_cannot_differentiate): JAX runs unsorted, the
    # port sorted (its reorder carrying the instance fields), one function
    model = jax_build_model(_pg(kind, jax_unsorted=True))
    pb = scene["pb"]
    params, stats = _jax_weights(_pg(kind))

    def both(p):
        out = model.apply({"params": p, "batch_stats": stats}, pb, train=False)

        def loss_fn(q):
            res, _ = model.apply({"params": q, "batch_stats": stats}, pb, train=True,
                                 rngs={"shuffle": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                                 mutable=["batch_stats", "diagnostics"])
            return res["loss"], {k: res[k] for k in ("seg_loss", "bias_l1_loss", "bias_cosine_loss")}

        return out, jax.value_and_grad(loss_fn, has_aux=True)(p)

    out, ((loss, terms), grads) = jax.jit(both)(params)
    return dict(kind=kind, params=params, stats=stats,
                out={k: np.asarray(out[k], np.float32) for k in ("seg_logits", "bias_pred", "loss", "seg_loss",
                                                                  "bias_l1_loss", "bias_cosine_loss")},
                train=dict(loss=float(loss), **{k: float(v) for k, v in terms.items()}),
                grads=jax.tree_util.tree_map(np.asarray, grads))


def _port_model(pg, **extra):
    model = build_model(_pg(pg["kind"], **extra), device="cpu")
    model.load_state_dict(params_from_jax(pg["params"], pg["stats"]), strict=True)
    return model


def test_pg_eval_matches_jax(pg, scene):
    """``seg_logits`` and ``bias_pred`` < 1e-2 relative (bf16 conv and
    attention operands on both sides), argmax > 0.99; the three losses
    < 2e-2 relative."""
    model = _port_model(pg)
    res = model(make_point_batch(scene["arrays"], 1, device="cpu"))
    v = scene["arrays"]["batch"] >= 0
    for key in ("seg_logits", "bias_pred"):
        got, want = res[key].numpy()[v], pg["out"][key][v]
        assert np.isfinite(got).all() and _rel(got, want) < 1e-2, (key, _rel(got, want))
    agree = (res["seg_logits"].numpy()[v].argmax(1) == pg["out"]["seg_logits"][v].argmax(1)).mean()
    assert agree > 0.99, agree
    for key in ("seg_loss", "bias_l1_loss", "bias_cosine_loss", "loss"):
        got, want = float(res[key]), float(pg["out"][key])
        assert abs(got - want) < 2e-2 * abs(want), (key, got, want)
    assert sum(int(x) for vs in res["diagnostics"].values() for x in vs) == 0
    if pg["kind"] == "ptv3":
        assert model.backbone.sorted_layout


def _grads(model, arrays, nudge=None):
    model.train()
    if nudge is not None:
        arrays = dict(arrays, feat=arrays["feat"] * nudge)
    res = model(make_point_batch(arrays, 1, device="cpu"), generator=torch.Generator().manual_seed(0))
    res["loss"].backward()
    return res, {n: p.grad.numpy().copy() for n, p in model.named_parameters() if p.grad is not None}


def test_pg_train_step_matches_jax(pg, scene):
    """One train step: the three loss terms < 2e-2 relative; every gradient
    < 5e-2 relative L2 with cosine > 0.999, or within twice the port's own
    noise floor (its gradients on features scaled by 1 + 1e-6 N(0, 1)) where
    that floor is above them, as tests/test_torch_port_spunet.py; the heads'
    within the plain bounds; every tensor moved by AdamW."""
    arrays = scene["arrays"]
    model = _port_model(pg)
    optimizer = build_optimizer(OPTIMIZER, model)
    step = build_train_step(model, optimizer, build_scheduler(SCHEDULER, optimizer, total_steps=1000))
    res = step(make_point_batch(arrays, 1, device="cpu"), torch.Generator().manual_seed(0))
    for key in ("seg_loss", "bias_l1_loss", "bias_cosine_loss", "loss"):
        got, want = float(res[key]), pg["train"][key]
        assert abs(got - want) < 2e-2 * abs(want), (key, got, want)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    want = {k: v.numpy() for k, v in params_from_jax(pg["grads"], {}).items()}
    assert set(got) == set(want)
    nudge = 1 + 1e-6 * np.random.RandomState(0).randn(*arrays["feat"].shape).astype(np.float32)
    _, floor = _grads(_port_model(pg), arrays, nudge)
    gmax = max(float(np.abs(g).max()) for g in want.values())
    bad = {}
    for n, g in got.items():
        if max(np.abs(g).max(), np.abs(want[n]).max()) < 1e-6 * gmax:
            continue  # a bias that feeds only a train-mode BatchNorm: rounding noise on both sides
        f, fc = _rel_l2(floor[n], g), _cos(floor[n], g)
        err, cos = _rel_l2(g, want[n]), _cos(g, want[n])
        if not (err < max(5e-2, 2 * f) and cos > min(0.999, 1 - 2 * (1 - fc))):
            bad[n] = (err, cos, f, fc)
    assert not bad, bad
    for name in ("bias_head.3.weight", "seg_head.weight"):
        assert _rel_l2(got[name], want[name]) < 5e-2 and _cos(got[name], want[name]) > 0.999, name

    after = dict(model.named_parameters())
    unmoved = [n for n, v in params_from_jax(pg["params"], {}).items() if torch.equal(after[n].detach(), v)]
    assert unmoved == []


# ------------------------------------------------------------ proposals and AP


def _predictions(seed):
    """A parsed synthetic scene and predictions near its truth: the true
    class's probability raised, offsets the true ones plus noise, a fifth of
    the points' classes drawn at random."""
    sc = TRANSFORMS.build(dict(type="InstanceParser", segment_ignore_index=IGNORE))(
        _raw_scene(seed, points=20000, extent=4.0))
    rng = np.random.RandomState(seed)
    n = sc["coord"].shape[0]
    seg = np.where(rng.rand(n) < 0.2, rng.randint(0, 20, n), sc["segment"])
    logits = rng.randn(n, 20).astype(np.float32)
    logits[np.arange(n), seg] += 4.0
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    has = sc["instance"] >= 0
    bias = np.where(has[:, None], sc["instance_centroid"] - sc["coord"], 0.0).astype(np.float32)
    bias += rng.randn(n, 3).astype(np.float32) * 0.02
    return sc, prob, bias


def _shifted(classes):
    """Classes with ScanNet's ignored 0 and 1 removed, as `evaluate_scene`
    takes them."""
    return classes - np.greater(classes[:, None], [0, 1]).sum(1)


def test_proposals_and_ap_match_jax():
    """`propose_instances` on the same numpy inputs (masks and classes
    equal, scores to 1e-6); then the port's records of two scenes (the
    evaluator's and tester's `scene_records`) against the JAX package's
    `evaluate_scene` of the same proposals, their classes shifted past the
    ignored ones, and `aggregate_ap`: equal exactly."""
    jmodel = jax_build_model(_pg("spunet", voxel_size=0.02))
    model = build_model(_pg("spunet", voxel_size=0.02), device="cpu")
    records, jrecords = {c: [] for c in range(18)}, {c: [] for c in range(18)}
    counts, jcounts = {c: 0 for c in range(18)}, {c: 0 for c in range(18)}
    proposals = 0
    for scene_id, seed in enumerate((11, 12)):
        sc, prob, bias = _predictions(seed)
        n = sc["coord"].shape[0]
        args = (sc["coord"], bias, prob, np.zeros(n, np.int32), np.ones(n, bool))
        got, want = model.propose_instances(*args), jmodel.propose_instances(*args)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
        proposals += len(got[2])
        host = dict(batch=np.zeros(n, np.int32), instance=sc["instance"], segment=sc["segment"])
        scene_records(*got, host, 1, 18, IGNORE, records, counts, scene_id)
        r, c = jeval.evaluate_scene(want[0], _shifted(want[1]), want[2], sc["instance"], sc["segment"], 18, IGNORE)
        for k, lst in r.items():
            jrecords[k].extend((s, i, scene_id) for s, i in lst)
        for k, v in c.items():
            jcounts[k] += v
    assert proposals >= 4
    assert counts == jcounts
    for c in records:
        assert [(s, list(i), k) for s, i, k in records[c]] == [(s, list(i), k) for s, i, k in jrecords[c]]
    got, want = teval.aggregate_ap(records, counts, 18), jeval.aggregate_ap(jrecords, jcounts, 18)
    assert got == want and 0.3 < got["AP50"] <= 1, got


def test_jax_insseg_classes_unshifted():
    """Fault 7: the JAX evaluator and tester give `evaluate_scene` the
    proposals' argmax classes as they are, where its GT classes have the
    ignored ones removed (ScanNet's class c is GT class c - 2): a perfect
    prediction of every instance scores AP 0 there. The port's records shift
    the proposals' classes as the GT's (AP 1)."""
    sc = TRANSFORMS.build(dict(type="InstanceParser", segment_ignore_index=IGNORE))(_raw_scene(11, points=4000))
    ids = np.unique(sc["instance"][sc["instance"] >= 0])
    masks = np.stack([sc["instance"] == i for i in ids])
    classes = np.array([sc["segment"][m][0] for m in masks], np.int32)
    scores = np.linspace(0.9, 0.5, len(ids)).astype(np.float32)
    r, c = jeval.evaluate_scene(masks, classes, scores, sc["instance"], sc["segment"], 18, IGNORE)
    jax_ap = jeval.aggregate_ap({k: [(s, i, 0) for s, i in v] for k, v in r.items()}, c, 18)
    records, counts = {}, {}
    host = dict(batch=np.zeros(len(sc["segment"]), np.int32), instance=sc["instance"], segment=sc["segment"])
    scene_records(masks, classes, scores, host, 1, 18, IGNORE, records, counts, 0)
    port_ap = teval.aggregate_ap(records, counts, 18)
    assert len(ids) > 4 and jax_ap["AP50"] == 0.0 and port_ap["mAP"] == port_ap["AP50"] == 1.0


def test_write_submission_matches_jax(tmp_path):
    """The manifest and the run-length masks, byte for byte."""
    rng = np.random.RandomState(0)
    masks = rng.rand(4, 500) < 0.3
    masks[2] = False
    classes, scores = np.array([3, 7, 1, 12], np.int32), rng.rand(4).astype(np.float32)
    files = {}
    for name, cls in (("port", InsSegTester), ("jax", JaxInsSegTester)):
        tester = cls.__new__(cls)
        tester.cfg = SimpleNamespace(save_path=str(tmp_path / name))
        tester.write_submission("scene0000_00", masks, classes, scores)
        root = tmp_path / name / "result" / "submit"
        files[name] = {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}
    assert files["port"] == files["jax"] and len(files["port"]) == 5


# ------------------------------------------------------------ evaluator and tester


def _write_scannet(root: Path, split: str, seed: int):
    sc = synthesize_scene(seed, num_points=3000, num_classes=20, extent=2.0)
    d = root / split / f"scene{seed:04d}_00"
    d.mkdir(parents=True)
    np.save(d / "coord.npy", sc["coord"])
    np.save(d / "color.npy", sc["color"].astype(np.uint8))
    np.save(d / "normal.npy", sc["normal"])
    np.save(d / "segment20.npy", sc["segment"].astype(np.int16))
    np.save(d / "instance.npy", sc["instance"].astype(np.int16))


TINY = {"model.backbone.base_channels": 8, "model.backbone.channels": SPUNET["channels"],
        "model.backbone.layers": SPUNET["layers"], "model.backbone_out_channels": 24,
        "model.backbone.pool_capacity_factor": 1.0, "model.cluster_min_points": 5,
        "model.cluster_propose_points": 5, "model.segment_ignore_index": (-1,), "enable_amp": False,
        "batch_size": 2, "batch_size_val": 2, "num_worker": 0, "epoch": 1, "eval_epoch": 1, "seed": 0,
        "point_capacity": 6144, "point_capacity_val": 6144, "point_capacity_test": 4096}


def test_evaluator_and_tester_through_the_config(tmp_path):
    """The SpUNet PointGroup config, shrunk (widths 8-24, two 5,000-point
    scenes a split), through the port's trainer and `InsSegEvaluator` (a val
    batch of both scenes, split into one record a scene) and then
    `InsSegTester` on the trained weights, which tests on ``data.val``
    (``test=dict()``). The evaluator's AP equals JAX's `evaluate_scene` and
    `aggregate_ap` on the same forward, scene by scene, and the tester's
    (the same weights and scenes) equals it."""
    from pointcept_tpu_torch.engines import default_config_parser
    from pointcept_tpu_torch.engines.test import main_worker as test_worker
    from pointcept_tpu_torch.engines.train import main_worker

    data = tmp_path / "scannet"
    for split, seeds in (("train", (1, 2)), ("val", (3, 4))):
        for seed in seeds:
            _write_scannet(data, split, seed)
    options = dict(TINY, save_path=str(tmp_path / "run"),
                   **{"data.train.data_root": str(data), "data.val.data_root": str(data)})
    cfg = default_config_parser(str(ROOT / "configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py"), options)
    trainer = main_worker(cfg, device="cpu")
    result = trainer.comm_info["eval_result"]
    assert trainer.comm_info["current_metric_name"] == "mAP" and np.isfinite(result["mAP"])
    assert len(result["proposals"]) == 2 and result["overflow"] == 0 and result["gt_instances"] > 0
    assert sum(result["proposals"]) > 0

    # the evaluator's records against the JAX package's functions on the same forward, scene by scene
    model, num_classes = trainer.model.eval(), 18
    records, counts = {c: [] for c in range(num_classes)}, {c: 0 for c in range(num_classes)}
    for batch in trainer.val_loader:
        out = model(make_point_batch(batch, batch["num_scenes"], device="cpu"))
        prob = torch.softmax(out["seg_logits"].float(), -1).numpy()
        for s in range(batch["num_scenes"]):
            rows = np.asarray(batch["batch"]) == s
            arrays = {k: np.asarray(batch[k])[rows] for k in ("coord", "instance", "segment")}
            jmodel = jax_build_model(dict(cfg.model))
            masks, classes, scores = jmodel.propose_instances(
                arrays["coord"], out["bias_pred"].numpy()[rows], prob[rows], np.zeros(rows.sum(), np.int32),
                np.ones(rows.sum(), bool))
            r, c = jeval.evaluate_scene(masks, _shifted(classes), scores, arrays["instance"], arrays["segment"],
                                        num_classes, IGNORE)
            for k, lst in r.items():
                records[k].extend((sc, i, s) for sc, i in lst)
            for k, v in c.items():
                counts[k] += v
    want = jeval.aggregate_ap(records, counts, num_classes)
    assert {k: result[k] for k in want} == want

    test_options = dict(TINY, save_path=str(tmp_path / "test"), weight=str(tmp_path / "run/model/model_last.pth"),
                        **{"data.val.data_root": str(data)})
    tester, tested = test_worker(default_config_parser(str(ROOT / "configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py"),
                                                       test_options), device="cpu")
    assert isinstance(tester, InsSegTester) and len(tester.scene_stats) == 2
    assert tested == want
    assert all(st["dropped"] == 0 and st["cluster_ms"] >= 0 for st in tester.scene_stats)


# ------------------------------------------------------------ faults not copied


def test_jax_insseg_tester_builds_empty_test_data():
    """Fault 1: the insseg configs say ``test=dict()`` (testing on the val
    data); the JAX tester builds ``data.test`` as it is, and its dataset
    builder raises on the empty dict. The port's `InsSegTester` takes
    ``data.val`` there."""
    path = str(ROOT / "configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py")
    jcfg = JaxConfig.fromfile(path)
    assert dict(jcfg.data.test) == {} and jcfg.test.type == "InsSegTester" and JAX_TESTERS.get("InsSegTester")
    with pytest.raises(KeyError, match="type"):
        jax_build_dataset(dict(jcfg.data.test))
    tester = InsSegTester.__new__(InsSegTester)
    tester.cfg = Config.fromfile(path)
    assert tester.test_data_config() == dict(tester.cfg.data.val)


def test_jax_pg_frozen_backbone_decays(scene):
    """Fault 2: PG-v1m2's ``freeze_backbone`` in the JAX package stops the
    gradient at the features, so every backbone gradient is 0, and AdamW's
    decay (the Sonata and Concerto ``-lin`` configs' 0.05) still moves every
    nonzero backbone tensor. The port's frozen backbone requires no
    gradient, sits in no optimizer group and stays bit for bit; its heads'
    gradients equal JAX's (5e-2 relative L2, cosine 0.999). A two-level
    SpUNet, to keep JAX's compile short."""
    cfg = dict(_pg("spunet", freeze_backbone=True), type="PG-v1m2",
               backbone=dict(SPUNET, channels=(8, 16, 16, 24), layers=(1,) * 4), criteria=None)
    jmodel = jax_build_model({k: v for k, v in cfg.items() if k != "criteria"})
    params, stats = _jax_weights(cfg)

    def loss_fn(p):
        res, _ = jmodel.apply({"params": p, "batch_stats": stats}, scene["pb"], train=True, mutable=["batch_stats"])
        return res["loss"]

    grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(params))
    assert all(not g.any() for g in jax.tree_util.tree_leaves(grads["backbone_module"]))
    tx = jax_build_optimizer(OPTIMIZER, params, jax_build_scheduler(SCHEDULER, total_steps=1000), None)
    after = jax.jit(lambda g, q: optax.apply_updates(q, tx.update(g, tx.init(q), q)[0]))(grads, params)
    jax_after = params_from_jax(jax.tree_util.tree_map(np.asarray, after), {})
    initial = params_from_jax(params, stats)
    backbone = [k for k in jax_after if k.startswith("backbone.") and initial[k].abs().sum() > 0]
    assert len(backbone) > 10 and all(not torch.equal(jax_after[k], initial[k]) for k in backbone)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(initial, strict=True)
    optimizer = build_optimizer(OPTIMIZER, model)
    step = build_train_step(model, optimizer, build_scheduler(SCHEDULER, optimizer, total_steps=1000))
    step(make_point_batch(scene["arrays"], 1, device="cpu"), torch.Generator().manual_seed(0))
    grouped = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert {n for n, p in model.named_parameters() if id(p) in grouped} == {
        n for n, _ in model.named_parameters() if not n.startswith("backbone.")}
    jgrads = params_from_jax(grads, {})
    for name, p in model.named_parameters():
        if name.startswith("backbone."):
            assert torch.equal(p.detach(), initial[name]) and p.grad is None, name
        elif name != "bias_head.0.bias":  # feeds a train-mode BatchNorm alone: rounding noise on both sides
            g, jg = p.grad.numpy(), jgrads[name].numpy()
            assert _rel_l2(g, jg) < 5e-2 and _cos(g, jg) > 0.999, name


def test_jax_sorted_layout_cannot_differentiate(scene):
    """Why the JAX side of the PT-v3 tests above runs unsorted: the JAX
    PT-v3m1's sorted layout (taken without host geometry and without the
    order shuffle) permutes the batch in one packed gather whose VJP fails
    on the integer grid's float0 cotangent while tracing. The JAX trainer
    never takes it (its host geometry); the port's sorted layout trains
    (`test_pg_train_step_matches_jax`, ``ptv3``)."""
    model = jax_build_model(_pg("ptv3"))
    params, stats = _jax_weights(_pg("ptv3"))

    def loss_fn(p):
        res, _ = model.apply({"params": p, "batch_stats": stats}, scene["pb"], train=True,
                             rngs={"shuffle": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                             mutable=["batch_stats", "diagnostics"])
        return res["loss"]

    with pytest.raises(AssertionError, match="float0"):
        jax.eval_shape(jax.grad(loss_fn), params)


PPT_PG = ["scannet/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py", "s3dis/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py",
          "s3dis/insseg-ppt-v1m1-0-pointgroup-spunet-ft-vs0p05.py"]


@pytest.mark.parametrize("path", PPT_PG)
def test_ppt_pointgroup_configs_refuse(path):
    """Fault 3: the PPT PointGroup fine-tunes put SpUNet-v1m3 (decoupled,
    adaptive PDNorm) under PG-v1m1, which has no context table, and their
    pipelines add no condition: no batch could drive those norms (the JAX
    PDNorm asserts on both). The port refuses the config before building
    anything, naming what is missing; the model itself builds."""
    cfg = Config.fromfile(str(ROOT / "configs" / path))
    bb = dict(cfg.model.backbone)
    assert cfg.model.type == "PG-v1m1" and bb["type"] == "SpUNet-v1m3" and bb["norm_adaptive"]
    with pytest.raises(ValueError, match="needs each batch's condition"):
        check_conditions(cfg)
    with_condition = copy.deepcopy(cfg)
    for part in ("train", "val"):
        with_condition.data[part].transform = [dict(type="Add", keys_dict=dict(condition="ScanNet"))] + list(
            with_condition.data[part].transform)
    with pytest.raises(ValueError, match="adaptive"):
        check_conditions(with_condition)
    with torch.device("meta"):
        MODELS.build(apply_amp_policy(dict(cfg.model), cfg.enable_amp))


SUBMIT = ["scannetpp/insseg-pointgroup-v1m2-1-ptv3-submit.py", "scannetpp/insseg-pointgroup-v1m1-1-spunet-submit.py"]


@pytest.mark.parametrize("path", SUBMIT)
def test_scannetpp_submit_configs(path, tmp_path):
    """Fault 4: the ScanNet++ ``-submit`` configs test on ``split="test"``
    with no transform and no ``submit`` key. On a test scene in ScanNet++'s
    layout the JAX tester fails at its first scene (its pad reads an
    ``offset`` no `Collect` made); the port's refuses at its build, naming
    the missing `Collect` and ``submit``."""
    d = tmp_path / "test" / "0a1b2c3d4e"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for asset, value in (("coord", rng.rand(50, 3)), ("color", rng.rand(50, 3) * 255), ("normal", rng.rand(50, 3))):
        np.save(d / f"{asset}.npy", value.astype(np.float32))
    jcfg = JaxConfig.fromfile(str(ROOT / "configs" / path))
    assert dict(jcfg.data.test) == dict(type="ScanNetPPDataset", data_root="data/scannetpp", split="test")
    jcfg.data.test.data_root = str(tmp_path)
    jcfg.save_path = str(tmp_path / "jax")
    (tmp_path / "jax").mkdir()
    with pytest.raises(KeyError, match="offset"):
        JAX_TESTERS.build(dict(jcfg.test, cfg=jcfg))
    tester = InsSegTester.__new__(InsSegTester)
    tester.cfg = Config.fromfile(str(ROOT / "configs" / path))
    with pytest.raises(ValueError, match="Collect.*submit"):
        tester.test_data_config()
