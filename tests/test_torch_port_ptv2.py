"""Point Transformer V2 (PT-v2m1/m2/m3), the Context-Aware Classifier, the
Matterport / AEO datasets and the hooks of the same slice, against the JAX
package on the CPU.

Small sizes (the sizes of tests/test_ptv2.py): two scenes of ~800-1,200
points in 2,048 rows, one or two stages at widths 8-32. The port's
seeded weights go to JAX through the JAX package's `convert_state_dict(sd,
"PT-v2m2")`, or, where it has no names (m1's grouped weight, m3's PDNorm
lists, CAC's heads), through `_jax_tree`, which fills the JAX tree's leaves
from the port's state dict by `params_from_jax`'s names. Bounds: logits <
1e-2 relative with argmax > 0.99 in f32; a train step's loss < 2e-2,
gradients < 5e-2 relative L2 and cosine > 0.999, a gradient that vanishes in
JAX (a bias before a norm or a softmax: below 1e-4 of the largest, measured
1e-8 to 2e-6; the others 1e-2 and more) held below 1e-4 of the largest;
measured ~1e-6 on every other count.

JAX's eager train-mode apply of PT-v2 differs from its jitted one (by ~0.7
in the logits of the m2 model here); the port is held to the jitted one,
which the JAX package's trainer runs."""

import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcept_tpu.datasets import build_dataset as jax_build_dataset
from pointcept_tpu.engines.hooks import evaluator as jax_evaluator
from pointcept_tpu.engines.train import make_point_batch as jax_point_batch
from pointcept_tpu.models import build_model as jax_build_model
from pointcept_tpu.models.point_transformer_v2 import point_transformer_v2 as jptv2
from pointcept_tpu.models.utils.convert import convert_state_dict
from pointcept_tpu.ops import pointops as jpointops
from pointcept_tpu.utils.config import Config as JaxConfig
from pointcept_tpu_torch.datasets import build_dataset, synthesize_scene
from pointcept_tpu_torch.engines import default_config_parser, make_point_batch
from pointcept_tpu_torch.engines.train import main_worker
from pointcept_tpu_torch.models import build_model
from pointcept_tpu_torch.models.point_transformer_v2 import point_transformer_v2 as tptv2
from pointcept_tpu_torch.models.utils.convert import params_from_jax
from pointcept_tpu_torch.ops import pointops
from pointcept_tpu_torch.ops.segment_ops import RowRuns

ROOT = Path(__file__).resolve().parents[1]
CE = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]


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


def _arrays(counts, cap, seed=0, classes=13, box=(3.0, 3.0, 1.5)):
    """Scenes of uniform points in a box, one after another, then padding
    (batch -1); each point in a 5 cm voxel of its own (SpUNet's grid
    coordinates are voxels, one point each)."""
    rs = np.random.RandomState(seed)
    a = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
             grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32),
             segment=np.full(cap, -1, np.int32))
    cells = np.asarray(box) / 0.05
    pos = 0
    for b, c in enumerate(counts):
        grid = np.stack(np.unravel_index(rs.choice(int(np.prod(cells)), c, replace=False), cells.astype(int)), 1)
        a["coord"][pos : pos + c] = ((grid + rs.rand(c, 3)) * 0.05).astype(np.float32)
        a["grid_coord"][pos : pos + c] = grid
        a["feat"][pos : pos + c] = rs.randn(c, 6)
        a["batch"][pos : pos + c] = b
        a["segment"][pos : pos + c] = np.where(rs.rand(c) < 0.1, -1, rs.randint(0, classes, c))
        pos += c
    return a


def _jax_batch(a, num_scenes, condition=None):
    return jax_point_batch({k: jnp.asarray(v) for k, v in a.items()}, num_scenes, condition=condition)


def _jax_tree(model, jm, pb):
    """The JAX (params, batch_stats) of `jm` holding the port `model`'s
    weights: each leaf of the JAX tree (shapes by `jax.eval_shape`) numbered,
    the numbered trees through `params_from_jax`, and each port tensor put
    back at the leaf its number names (a kernel transposed). Every
    leaf must be named once and every port tensor used."""
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, pb, train=False))
    trees = {k: jax.tree_util.tree_flatten_with_path(shapes[k]) for k in ("params", "batch_stats")}
    leaves = [(k, path, s) for k, (flat, _) in trees.items() for path, s in flat]
    numbered = {k: jax.tree_util.tree_unflatten(
        trees[k][1], [np.full(s.shape, float(i), np.float32) for i, (kk, _, s) in enumerate(leaves) if kk == k])
        for k in trees}
    names = params_from_jax(numbered["params"], numbered["batch_stats"])
    owner = {int(t.reshape(-1)[0]): name for name, t in names.items()}
    assert len(owner) == len(leaves) == len(names)
    sd = model.state_dict()
    assert set(owner.values()) == {k for k in sd if not k.endswith("num_batches_tracked")}
    values = {k: [] for k in trees}
    for i, (k, path, s) in enumerate(leaves):
        v = sd[owner[i]].numpy()
        values[k].append(jnp.asarray(v.T if str(path[-1].key).endswith("kernel") else v).reshape(s.shape))
    return tuple(jax.tree_util.tree_unflatten(trees[k][1], values[k]) for k in ("params", "batch_stats"))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cos(got, want):
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _check_grads(got: dict, want: dict):
    assert set(got) == set(want)
    gmax = max(float(np.abs(w).max()) for w in want.values())
    bad = {}
    for n, w in want.items():
        g = got[n]
        if float(np.abs(w).max()) < 1e-4 * gmax:  # vanishes: a bias before a norm or a softmax
            if float(np.abs(g).max()) >= 1e-4 * gmax:
                bad[n] = ("vanishing", float(np.abs(g).max()) / gmax)
        elif not (_rel(g, w) < 5e-2 and _cos(g, w) > 0.999):
            bad[n] = (_rel(g, w), _cos(g, w))
    assert not bad, bad


def _check_logits(got, want, valid):
    got, want = got[valid], want[valid]
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    agree = (got.argmax(1) == want.argmax(1)).mean()
    assert err < 1e-2 and agree > 0.99, (err, agree)


# ------------------------------------------------------------ point ops


def test_knn_query_scene_bounded_matches_jax():
    """Scene-contiguous rows with padding at the end, a scene of fewer
    points than k and queries of a scene without base points: the
    scene-bounded chunks (256 rows, most inside one scene) give the same as
    one chunk over every column; the exact k nearest (f64) wherever the
    k-th and (k+1)-th exact distances differ by > 1e-6, JAX's neighbours
    and distances (to 1e-5) where they differ by > 1e-4 (JAX selects by the
    rounded expansion alone); index 0 at distance sqrt(BIG) where no
    neighbour exists."""
    a = _arrays([700, 500, 5], 1536, seed=2)
    base, bb = a["coord"], a["batch"]
    qb = np.where(bb >= 0, bb, -2)
    qb[1205:1210] = 3  # a scene the base does not hold
    k = 8
    wi, wd = map(np.asarray, jax.jit(jpointops.knn_query, static_argnums=0)(
        k, jnp.asarray(base), jnp.asarray(bb), jnp.asarray(base), jnp.asarray(qb)))
    args = (torch.as_tensor(base), torch.as_tensor(bb), torch.as_tensor(base), torch.as_tensor(qb))
    gi, gd = (t.numpy() for t in pointops.knn_query(k, *args, chunk=256))
    fi, fd = (t.numpy() for t in pointops.knn_query(k, *args, chunk=4096))
    np.testing.assert_array_equal(gi, fi)
    np.testing.assert_array_equal(gd, fd)
    exact = np.sqrt(((base[:, None].astype(np.float64) - base[None].astype(np.float64)) ** 2).sum(-1))
    exact = np.where((qb[:, None] == bb[None]) & (bb[None] >= 0), exact, np.inf)
    srt = np.sort(exact, axis=1)
    with np.errstate(invalid="ignore"):  # rows of k neighbours or more (the others below)
        gap = np.where(np.isfinite(srt[:, k - 1]), srt[:, k] - srt[:, k - 1], -1.0)
    # the port re-ranks by exact distances: the exact k nearest wherever they are defined
    want = np.sort(np.argsort(exact, axis=1, kind="stable")[:, :k], axis=1)
    clear = gap > 1e-6
    np.testing.assert_array_equal(np.sort(gi, axis=1)[clear], want[clear])
    # JAX selects by |q|^2 + |b|^2 - 2 q.b alone: its rounding (~1e-6 of a squared
    # distance here) can swap a k-th neighbour closer than 1e-4
    wide = gap > 1e-4
    assert wide.sum() > 0.9 * (gap >= 0).sum()
    np.testing.assert_array_equal(np.sort(gi, axis=1)[wide], np.sort(wi, axis=1)[wide])
    np.testing.assert_allclose(np.sort(gd, axis=1)[wide], np.sort(wd, axis=1)[wide], rtol=1e-5)
    none = ~np.isfinite(srt[:, 0])
    assert none.sum() == 1536 - 1205 and (gi[none] == 0).all() and (gd[none] == np.float32(np.sqrt(1e10))).all()
    few = bb == 2  # 5 points: 3 of the 8 slots repeat the first found
    assert (gi[few, 5:] == gi[few, :1]).all() and (gd[few, 5:] == np.float32(np.sqrt(1e10))).all()


@pytest.mark.parametrize("lattice", [False, True], ids=["uniform", "lattice"])
def test_knn_self_query_in_space_equals_the_scene_search(lattice):
    """The self query's search in space (z-order chunks, each among
    the points of its widened box) gives the scene-bounded search's
    neighbours and distances bit for bit: three scenes (one of fewer points
    than k) and padding, on uniform points and on a 2 cm lattice (exact
    distance ties, to the lower index in both)."""
    rs = np.random.RandomState(4)
    counts, cap = [1800, 5, 1200], 3200
    coord, batch, pos = np.zeros((cap, 3), np.float32), np.full(cap, -1, np.int32), 0
    for b, c in enumerate(counts):
        pts = rs.rand(c, 3) * [3, 3, 1.5]
        coord[pos : pos + c] = np.floor(pts / 0.02) * 0.02 if lattice else pts
        batch[pos : pos + c] = b
        pos += c
    c, b = torch.as_tensor(coord), torch.as_tensor(batch)
    for k in (8, 16):
        got = pointops.knn_query(k, c, b)
        want = pointops.knn_query(k, c, b, c, torch.where(b >= 0, b, -2))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_interpolation_matches_jax():
    """3-NN inverse-distance interpolation from a coarse set onto a fine one
    (padding on both sides), and its gradient to the source features."""
    src, dst = _arrays([300, 200], 640, seed=3), _arrays([700, 500], 1280, seed=4)
    feat = np.random.RandomState(5).randn(640, 16).astype(np.float32)
    r = np.random.RandomState(6).randn(1280, 16).astype(np.float32)

    def jfn(f):
        out = jpointops.interpolation(jnp.asarray(src["coord"]), jnp.asarray(src["batch"]), f,
                                      jnp.asarray(dst["coord"]), jnp.asarray(dst["batch"]))
        return jnp.sum(out * r), out

    (_, want), wgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(feat))
    f = torch.as_tensor(feat).requires_grad_()
    got = pointops.interpolation(torch.as_tensor(src["coord"]), torch.as_tensor(src["batch"]), f,
                                 torch.as_tensor(dst["coord"]), torch.as_tensor(dst["batch"]))
    (got * torch.as_tensor(r)).sum().backward()
    v = dst["batch"] >= 0
    np.testing.assert_allclose(got.detach().numpy()[v], np.asarray(want)[v], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(wgrad), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ modules


@pytest.mark.parametrize("capacity", [640, 128], ids=["ample", "dropping"])
def test_grid_pool_matches_jax(capacity):
    """GridPool in train mode on 1,200 points of two scenes at a 0.5 m grid
    (~6 points a voxel): each point's cluster (in key order; the capacity
    cut drops the same points, counted), the pooled batch ids, coordinates
    and feature max, and the gradients of the max to the input features
    and the weights, where ReLU's zeros tie the max inside a voxel (split
    evenly among the tied points in both packages)."""
    a = _arrays([700, 500], 1280, seed=7)
    feat = np.random.RandomState(8).randn(1280, 12).astype(np.float32)
    r = np.random.RandomState(9).randn(capacity, 16).astype(np.float32)
    pool = jptv2.GridPool(out_channels=16, grid_size=0.5, out_capacity=capacity, num_scenes=2)
    args = (jnp.asarray(a["coord"]), jnp.asarray(feat), jnp.asarray(a["batch"]), jnp.asarray(a["batch"] >= 0))
    variables = jax.jit(lambda key: pool.init(key, *args, True))(jax.random.PRNGKey(0))

    def jfn(params, f):
        out, _ = pool.apply({"params": params, "batch_stats": variables["batch_stats"]}, args[0], f, *args[2:],
                            True, mutable=["batch_stats"])
        return jnp.sum(out[1] * r), out

    (_, want), (wgp, wgf) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(variables["params"], args[1])
    port = tptv2.GridPool(12, 16, 0.5)
    port.load_state_dict({"fc.weight": torch.as_tensor(np.asarray(variables["params"]["fc"]["kernel"]).T),
                          "norm.norm.weight": torch.ones(16), "norm.norm.bias": torch.zeros(16),
                          "norm.norm.running_mean": torch.zeros(16), "norm.norm.running_var": torch.ones(16)})
    port.train()
    pb = make_point_batch({k: a[k] for k in ("coord", "batch")}, 2, device="cpu")
    f = torch.as_tensor(feat).requires_grad_()
    pooled, new_feat, cluster, dropped = port(pb, f, capacity)
    (new_feat * torch.as_tensor(r)).sum().backward()
    w_coord, w_feat, w_batch, _, w_cluster = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(cluster.numpy(), w_cluster)
    np.testing.assert_array_equal(pooled.batch.numpy(), w_batch)
    assert int(dropped) == int(((w_cluster == capacity) & (a["batch"] >= 0)).sum())
    assert (int(dropped) > 0) == (capacity == 128)
    np.testing.assert_allclose(pooled.coord.numpy(), w_coord, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new_feat.detach().numpy(), w_feat, rtol=1e-5, atol=1e-6)
    # ties: voxels whose max channel is held by several points (ReLU's zeros)
    x = torch.relu(port.norm(port.fc(f), pb.mask)).detach().numpy()
    kept = cluster.numpy() < capacity
    ties = sum(((x[kept & (cluster.numpy() == c)] == w_feat[c]).sum(axis=0) > 1).sum() for c in range(20))
    assert ties > 0
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(wgf), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.fc.weight.grad.numpy(), np.asarray(wgp["fc"]["kernel"]).T, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m1", [False, True], ids=["m2", "m1"])
def test_grouped_vector_attention_matches_jax(m1):
    """GroupedVectorAttention in train mode on one shared kNN (the port's,
    fed to both): m2 (position bias) and m1 (GroupedLinear weight encoding
    and the position multiplier): the output, and the gradients to the
    features and every weight."""
    a = _arrays([200, 100], 320, seed=11)
    n, c, g = 320, 16, 4
    mask = a["batch"] >= 0
    idx, _ = pointops.knn_query(8, torch.as_tensor(a["coord"]), torch.as_tensor(np.where(mask, a["batch"], -1)))
    feat = np.random.RandomState(12).randn(n, c).astype(np.float32)
    r = np.random.RandomState(13).randn(n, c).astype(np.float32)
    ja = jptv2.GroupedVectorAttention(embed_channels=c, groups=g, pe_multiplier=m1, grouped_linear=m1)
    args = (jnp.asarray(a["coord"]), jnp.asarray(idx.numpy()), jnp.asarray(mask))
    variables = jax.jit(lambda key: ja.init(key, jnp.asarray(feat), *args, False))(jax.random.PRNGKey(1))

    def jfn(params, f):
        out, _ = ja.apply({"params": params, "batch_stats": variables["batch_stats"]}, f, *args, True,
                          mutable=["batch_stats"])
        return jnp.sum(out * r), out

    (_, want), (wgp, wgf) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(variables["params"],
                                                                                  jnp.asarray(feat))
    wrap = lambda t: {"backbone_module": {"patch_embed": {"block0": {"attn": t}}}}  # noqa: E731
    prefix = "backbone.patch_embed.blocks.blocks.0.attn."
    sd = {k[len(prefix):]: v for k, v in params_from_jax(wrap(variables["params"]),
                                                         wrap(variables["batch_stats"])).items()}
    port = tptv2.GroupedVectorAttention(c, g, pe_multiplier=m1, grouped_linear=m1)
    port.load_state_dict(sd, strict=True)
    port.train()
    f = torch.as_tensor(feat).requires_grad_()
    out = port(f, torch.as_tensor(a["coord"]), RowRuns(idx.view(-1), n), torch.as_tensor(mask))
    (out * torch.as_tensor(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[mask], np.asarray(want)[mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(wgf), rtol=1e-4, atol=1e-4)
    want_grads = {k[len(prefix):]: v.numpy() for k, v in params_from_jax(wrap(jax.tree_util.tree_map(
        np.asarray, wgp)), {}).items()}
    _check_grads({n_: p.grad.numpy() for n_, p in port.named_parameters()}, want_grads)


# ------------------------------------------------------------ models

MODEL_CASES = {
    # two stages, the JAX package's converter both ways
    "m2": dict(type="PT-v2m2", patch_embed_channels=16, patch_embed_groups=2, enc_depths=(1, 1),
               enc_channels=(32, 32), enc_groups=(4, 8), enc_neighbours=(8, 8), dec_depths=(1, 1),
               dec_channels=(16, 32), dec_groups=(2, 4), dec_neighbours=(8, 8), grid_sizes=(0.3, 0.6),
               pool_capacity_factors=(0.6, 0.6)),
    # one stage each: the GroupedLinear with the position multiplier; PDNorm on the second condition
    "m1": dict(type="PT-v2m1", patch_embed_channels=16, patch_embed_groups=2, enc_depths=(1,), enc_channels=(32,),
               enc_groups=(4,), enc_neighbours=(8,), dec_depths=(1,), dec_channels=(16,), dec_groups=(2,),
               dec_neighbours=(8,), grid_sizes=(0.3,), pool_capacity_factors=(0.6,), pe_multiplier=True),
    "m3": dict(type="PT-v2m3", patch_embed_channels=16, patch_embed_groups=2, enc_depths=(1,), enc_channels=(32,),
               enc_groups=(4,), enc_neighbours=(8,), dec_depths=(1,), dec_channels=(16,), dec_groups=(2,),
               dec_neighbours=(8,), grid_sizes=(0.3,), pool_capacity_factors=(0.6,),
               conditions=("ScanNet", "S3DIS")),
}


def _jax_eval_and_step(jm, pb, params, stats, with_grads=True):
    """JAX's eval logits and one train step's (loss, named losses, batch
    stats, grads; grads None without `with_grads`), in one compile."""

    def run(p, s):
        logits = jm.apply({"params": p, "batch_stats": s}, pb, train=False)["seg_logits"]

        def loss_fn(q):
            out, upd = jm.apply({"params": q, "batch_stats": s}, pb, train=True, mutable=["batch_stats"])
            return out["loss"], (out, upd["batch_stats"])

        if with_grads:
            (loss, (out, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        else:
            (loss, (out, new_stats)), grads = loss_fn(p), None
        return logits, loss, {k: v for k, v in out.items() if k.endswith("_loss")}, new_stats, grads

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(params, stats))


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_matches_jax(name):
    """The eval logits and one train step (loss, the running statistics
    after it, and m2's every gradient) of PT-v2m2, m1 and m3 under
    DefaultSegmentor, the seeded port weights (running statistics moved off
    their init) in JAX; m3's other condition's norms stay as they were."""
    backbone = dict(MODEL_CASES[name], in_channels=6, num_classes=13, patch_embed_neighbours=8)
    cfg = dict(type="DefaultSegmentor", backbone=backbone, criteria=CE)
    a = _arrays([1100, 800], 2048)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(5)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                v.add_(torch.as_tensor(rs.rand(*v.shape).astype(np.float32)) * 0.5)
    condition = "S3DIS" if name == "m3" else None
    pb = _jax_batch(a, 2, condition)
    jm = jax_build_model(cfg)
    if name == "m2":
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        params, stats, unmatched = convert_state_dict(sd, "PT-v2m2")
        assert unmatched == []
        back = params_from_jax(params, stats)
        assert set(back) == set(sd) and all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)
    else:
        params, stats = _jax_tree(model, jm, pb)
    # m1's grouped weight gradient is held at the module (test_grouped_vector_attention_matches_jax)
    logits, loss, _, new_stats, grads = _jax_eval_and_step(jm, pb, params, stats, name == "m2")

    tpb = make_point_batch(a, 2, device="cpu", condition=condition)
    res = model(tpb)
    valid = a["batch"] >= 0
    _check_logits(res["seg_logits"].numpy(), logits, valid)
    assert [int(x) for x in res["diagnostics"]["pool_overflow"]] == [0] * len(backbone["enc_depths"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    res = model(tpb, generator=torch.Generator().manual_seed(0))
    res["loss"].backward()
    assert abs(float(res["loss"]) - float(loss)) < 2e-2 * abs(float(loss))
    want_stats = params_from_jax(params, new_stats)
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    if grads is not None:
        _check_grads({n: p.grad.numpy() for n, p in model.named_parameters()},
                     {n: t.numpy() for n, t in params_from_jax(grads, {}).items()})
    elif name == "m3":  # the norms of the condition the batch does not name neither move nor get a gradient
        idle = [k for k in before if ".bns.0." in k]
        assert idle and all(torch.equal(before[k], model.state_dict()[k]) for k in idle)
        assert all((p.grad is None) == (".bns.0." in n) for n, p in model.named_parameters())


CAC_BACKBONES = {
    "spunet": dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
                   channels=(8, 16, 32, 64, 64, 32, 24, 24), layers=(1,) * 8, serialize_depth=8),
    "ptv2": dict(MODEL_CASES["m1"], type="PT-v2m2", in_channels=6, num_classes=0, pe_multiplier=False,
                 dec_channels=(24,)),
}


@pytest.mark.parametrize("backbone", list(CAC_BACKBONES))
def test_cac_matches_jax(backbone):
    """CAC-v1m1 over a small SpUNet (gather engine, bf16 conv operands on
    both sides) and a small PT-v2m2: the eval logits (the refined
    prototypes' cosine logits) and loss, and a train step's four terms and
    their sum, with ``detach_pre_logits`` and ``conf_thresh``; over PT-v2
    (f32) every gradient too, over SpUNet (its bf16 convs, held apart by
    tests/test_torch_port_spunet.py) finite ones."""
    cfg = dict(type="CAC-v1m1", num_classes=13, backbone_out_channels=24, backbone=CAC_BACKBONES[backbone],
               criteria=CE, cos_temp=15, detach_pre_logits=True, conf_thresh=0.1)
    a = _arrays([1200, 800], 2048, seed=1)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(4)
    with torch.no_grad():  # the heads' biases off zero: a point projected to 0 has no direction
        for k, v in model.state_dict().items():
            if k.endswith(".bias") and not k.startswith("backbone."):
                v.add_(torch.as_tensor(rs.randn(*v.shape).astype(np.float32)) * 0.1)
    pb = _jax_batch(a, 2)
    jm = jax_build_model(cfg)
    params, stats = _jax_tree(model, jm, pb)
    logits, loss, terms, new_stats, grads = _jax_eval_and_step(jm, pb, params, stats, backbone == "ptv2")
    tpb = make_point_batch(a, 2, device="cpu")
    res = model(tpb)
    _check_logits(res["seg_logits"].numpy(), logits, a["batch"] >= 0)
    model.train()
    res = model(tpb, generator=torch.Generator().manual_seed(0))
    res["loss"].backward()
    for k in ("seg_loss", "pre_loss", "pre_self_loss", "kl_loss"):
        assert np.isfinite(float(res[k])) and abs(float(res[k]) - float(terms[k])) < 2e-2 * abs(float(terms[k])), k
    assert abs(float(res["loss"]) - float(loss)) < 2e-2 * abs(float(loss))
    if grads is not None:
        _check_grads({n: p.grad.numpy() for n, p in model.named_parameters()},
                     {n: t.numpy() for n, t in params_from_jax(grads, {}).items()})
    else:
        assert all(p.grad is not None and np.isfinite(p.grad.numpy()).all() for p in model.parameters())
    bn = "feat_proj_layer.1."
    np.testing.assert_allclose(model.state_dict()[bn + "running_mean"].numpy(),
                               np.asarray(new_stats["featproj_norm"]["mean"]), rtol=1e-3, atol=1e-5)


def test_jax_cac_over_ptv2_config_builds_a_seg_head():
    """ROADMAP queue 3 item 14.1: `semseg-cac-v1m1-2-ptv2-lovasz.py` replaces
    its base's backbone with ``_delete_`` and names no ``num_classes``; the
    JAX PT-v2m2's default of 20 builds a seg head, so CAC's 48-channel
    classifier meets 20-wide logits and the JAX model cannot initialise.
    The port's PT-v2 defaults to 0 (the reference takes it without a
    default) and hands CAC its 48-channel features."""
    cfg = JaxConfig.fromfile(str(ROOT / "configs/scannet/semseg-cac-v1m1-2-ptv2-lovasz.py"))
    model_cfg = dict(cfg.model)
    bb = dict(model_cfg["backbone"])
    assert "num_classes" not in bb and model_cfg["backbone_out_channels"] == 48
    small = dict(bb, enc_depths=(1,), enc_channels=(96,), enc_groups=(12,), enc_neighbours=(8,), dec_depths=(1,),
                 dec_channels=(48,), dec_groups=(6,), dec_neighbours=(8,), grid_sizes=(0.2,),
                 patch_embed_neighbours=8)
    small_cfg = dict(model_cfg, backbone=small)
    pb = _jax_batch(_arrays([300, 200], 640), 2)
    jm = jax_build_model(small_cfg)
    with pytest.raises(Exception, match="dot_general|shape|incompatible|contracting"):
        jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, pb, train=False))
    model = build_model(small_cfg, device="cpu")
    assert model.backbone.out_channels == 48 and not hasattr(model.backbone, "seg_head")
    assert model(make_point_batch(_arrays([300, 200], 640), 2, device="cpu"))["seg_logits"].shape == (640, 20)


# ------------------------------------------------------------ data and hooks


@pytest.mark.parametrize("kind", ["MatterportDataset", "AEODataset"])
def test_datasets_equal_jax(tmp_path, kind):
    """Both datasets read DefaultDataset's layout as the JAX package's do:
    the scene list and each `get_data` dict bit for bit, and Matterport3D's
    config pipeline (ScanNet's PT-v3 train transforms) on the same seeds."""
    for split, seeds in (("train", (0, 1)), ("val", (2,))):
        for seed in seeds:
            d = tmp_path / split / f"region{seed}"
            d.mkdir(parents=True)
            s = synthesize_scene(seed, num_points=1500, num_classes=21, extent=3.0)
            np.save(d / "coord.npy", s["coord"])
            np.save(d / "color.npy", s["color"].astype(np.uint8))
            np.save(d / "normal.npy", s["normal"])
            np.save(d / "segment.npy", s["segment"].astype(np.int16))
    cfg = dict(type=kind, data_root=str(tmp_path), split="train")
    ds, jds = build_dataset(dict(cfg)), jax_build_dataset(dict(cfg))
    assert ds.data_list == jds.data_list and len(ds) == 2
    for i in range(2):
        got, want = ds.get_data(i), jds.get_data(i)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if isinstance(w, np.ndarray):
                assert got[key].dtype == w.dtype
                np.testing.assert_array_equal(got[key], w, err_msg=key)
            else:
                assert got[key] == w
    if kind == "MatterportDataset":
        path = str(ROOT / "configs/matterport3d/semseg-pt-v3m1-0-base.py")
        options = {"data.train.data_root": str(tmp_path)}
        from pointcept_tpu_torch.utils.config import Config

        got_cfg, want_cfg = Config.fromfile(path), JaxConfig.fromfile(path)
        got_cfg.merge_from_dict(options)
        want_cfg.merge_from_dict(options)
        ds, jds = build_dataset(dict(got_cfg.data.train)), jax_build_dataset(dict(want_cfg.data.train))
        for seed in (0, 1):
            np.random.seed(seed)
            random.seed(seed)
            got = ds[1]
            np.random.seed(seed)
            random.seed(seed)
            want = jds[1]
            for key, w in want.items():
                if isinstance(w, np.ndarray):
                    np.testing.assert_array_equal(got[key], w, err_msg=key)


def _write_scannet(root: Path, split: str, seed: int, n: int = 1500):
    d = root / split / f"scene{seed:04d}_00"
    d.mkdir(parents=True)
    s = synthesize_scene(seed, num_points=n, num_classes=20, extent=2.0)
    np.save(d / "coord.npy", s["coord"])
    np.save(d / "color.npy", s["color"].astype(np.uint8))
    np.save(d / "normal.npy", s["normal"])
    np.save(d / "segment20.npy", s["segment"].astype(np.int16))
    np.save(d / "instance.npy", s["instance"].astype(np.int16))


PTV2_TINY = {"model.backbone.patch_embed_channels": 8, "model.backbone.patch_embed_groups": 2,
             "model.backbone.enc_depths": (1, 1), "model.backbone.enc_channels": (16, 16),
             "model.backbone.enc_groups": (2, 2), "model.backbone.enc_neighbours": (8, 8),
             "model.backbone.dec_depths": (1, 1), "model.backbone.dec_channels": (8, 16),
             "model.backbone.dec_groups": (2, 2), "model.backbone.dec_neighbours": (8, 8),
             "model.backbone.grid_sizes": (0.1, 0.25), "model.backbone.pool_capacity_factors": (1.0, 1.0),
             "enable_amp": False, "batch_size": 2, "batch_size_val": 1, "num_worker": 0, "epoch": 1,
             "eval_epoch": 1, "seed": 0, "point_capacity": 4096, "point_capacity_val": 2048,
             "point_capacity_test": 2048, "mix_prob": 0.0}


def test_ptv2_config_trains_then_precise_evaluator_tests(tmp_path):
    """The ScanNet PT-v2m2 config, shrunk (widths 8-16, two stages, four
    600-point scenes), through `main_worker`: 2 steps, the evaluation,
    then `PreciseEvaluator` (put in the config's hooks as
    `semseg-spunet-v1m1-1-precise-eval.py` does) runs the config's test
    section on `model_best`'s weights: every val point voted by each of
    the 13 views, nothing dropped."""
    data = tmp_path / "scannet"
    for split, seeds in (("train", (1, 2, 3, 4)), ("val", (5,))):
        for seed in seeds:
            _write_scannet(data, split, seed, n=600)
    hooks = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
             dict(type="InformationWriter"), dict(type="SemSegEvaluator"), dict(type="CheckpointSaver"),
             dict(type="PreciseEvaluator", test_last=False)]
    options = dict(PTV2_TINY, save_path=str(tmp_path / "run"), hooks=hooks,
                   **{"data.train.data_root": str(data), "data.val.data_root": str(data),
                      "data.test.data_root": str(data), "data.test.split": "val"})
    cfg = default_config_parser(str(ROOT / "configs/scannet/semseg-pt-v2m2-0-base.py"), options)
    trainer = main_worker(cfg, device="cpu")
    rows = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) and r["pool_overflow"] == 0 for r in rows)
    assert trainer.comm_info["eval_result"]["overflow"] == 0
    result = trainer.comm_info["precise_result"]
    assert np.isfinite(result["mIoU"]) and 0 <= result["allAcc"] <= 1
    pred = np.load(tmp_path / "run" / "result" / "scene0005_00_pred.npy")
    assert pred.shape == (600, 20) and pred.sum(axis=1).min() >= 13 * (1 - 1e-4)
    best = torch.load(tmp_path / "run" / "model" / "model_best.pth", weights_only=False)["state_dict"]
    assert all(torch.equal(v, trainer.model.state_dict()[k]) for k, v in best.items())


def test_runtime_profiler_v2_traces_its_active_steps(tmp_path):
    """`semseg-spunet-v1m1-3-enable-profiler.py`'s hook (wait 1, warmup 1,
    active 2, repeat 1) over a 4-step epoch of the shrunk SpUNet config:
    one trace, ``profile/cycle0/trace.json``, holding the active steps 2
    and 3 and no other."""
    data = tmp_path / "scannet"
    for split, seeds in (("train", (1, 2, 3, 4)), ("val", (5,))):
        for seed in seeds:
            _write_scannet(data, split, seed, n=800)
    options = {"model.backbone.base_channels": 8, "model.backbone.channels": (8, 16, 16, 16, 16, 16, 8, 8),
               "model.backbone.layers": (1,) * 8, "enable_amp": False, "batch_size": 1, "num_worker": 0,
               "seed": 0, "point_capacity": 1024, "point_capacity_val": 1024, "evaluate": False, "mix_prob": 0.0,
               "epoch": 1, "eval_epoch": 1, "save_path": str(tmp_path / "run"), "data.train.data_root": str(data),
               "data.val.data_root": str(data)}
    cfg = default_config_parser(str(ROOT / "configs/scannet/semseg-spunet-v1m1-3-enable-profiler.py"), options)
    main_worker(cfg, device="cpu")
    traces = sorted(p.relative_to(tmp_path / "run") for p in (tmp_path / "run" / "profile").rglob("*.json"))
    assert [str(p) for p in traces] == ["profile/cycle0/trace.json"]
    events = json.load(open(tmp_path / "run" / traces[0]))["traceEvents"]
    steps = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("train_step")})
    assert steps == ["train_step 2", "train_step 3"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


class _Loader(list):
    def __init__(self, batches, dataset):
        super().__init__(batches)
        self.dataset = dataset


class _Trainer:
    def __init__(self, loader, model):
        self.val_loader, self.model = loader, model
        self.cfg = {"evaluate": True}
        self.device = torch.device("cpu")
        self.comm_info, self.storage, self.best_metric_value = {}, None, 0.0
        self.logger = __import__("logging").getLogger("ptv2-test")


class _FixedLogits(torch.nn.Module):
    """A model whose eval forward returns the logits laid out for its batch."""

    def __init__(self, logits):
        super().__init__()
        self.logits, self.calls = logits, 0

    def forward(self, pb):
        out = torch.as_tensor(self.logits[self.calls])
        self.calls += 1
        return {"seg_logits": out, "diagnostics": {"pool_overflow": [], "block_overflow": []}}


class _JaxFixed:
    """The JAX hooks' `model.apply` over the same fixed logits."""

    def __init__(self, logits):
        self.logits, self.calls = logits, 0

    def __call__(self, pb, train=False):
        pass

    def apply(self, variables, pb, train=False, **kw):
        out = self.logits[self.calls]
        self.calls += 1
        return {"seg_logits": jnp.asarray(out)}


@pytest.mark.parametrize("kind", ["shapenet", "partnete"])
def test_part_seg_evaluators_equal_jax(kind):
    """ShapeNetPartSegEvaluator's ins.mIoU / cat.mIoU and
    PartNetEPartSegEvaluator's part.mIoU on the same val batches (two
    shapes a batch, the last batch padded by a scene of category -1) and
    logits equal the JAX hooks' to 1e-6."""
    from types import SimpleNamespace

    from pointcept_tpu_torch.datasets.shapenet_part import ShapeNetPartDataset
    from pointcept_tpu_torch.engines.hooks import HOOKS

    rng = np.random.RandomState(3)
    if kind == "shapenet":
        ds = SimpleNamespace(categories=ShapeNetPartDataset.categories,
                             category2part=ShapeNetPartDataset.category2part)
        labels, classes, key = (0, 11, 15, 4, 4), 50, "category"
    else:
        ds = SimpleNamespace(categories=["Bottle", "Chair"], num_parts=[3, 4],
                             category2part={"Bottle": [0, 1, 2], "Chair": [3, 4, 5, 6]})
        labels, classes, key = (0, 1, 1, 0, 1), 8, "cls_token"
    batches, logits = [], []
    for b0 in range(0, len(labels), 2):
        cats = list(labels[b0 : b0 + 2])
        n = [40 + 7 * (b0 + i) for i in range(len(cats))]
        cap = 128
        seg, batch = np.full(cap, -1, np.int32), np.full(cap, -1, np.int32)
        pos = 0
        for i, (c, m) in enumerate(zip(cats, n)):
            parts = np.asarray(ds.category2part[ds.categories[c]])
            seg[pos : pos + m] = rng.choice(parts, m) + (1 if kind == "partnete" else 0)
            batch[pos : pos + m] = i
            pos += m
        tags = np.full(2, -1, np.int32)
        tags[: len(cats)] = cats
        batches.append(dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                            batch=batch, segment=seg, num_scenes=2, **{key: tags}))
        logits.append(rng.rand(cap, classes).astype(np.float32))
    hook = HOOKS.build(dict(type="ShapeNetPartSegEvaluator" if kind == "shapenet" else "PartNetEPartSegEvaluator"))
    hook.trainer = _Trainer(_Loader(batches, ds), _FixedLogits(logits))
    got = hook.eval()

    jhook = (jax_evaluator.ShapeNetPartSegEvaluator if kind == "shapenet" else jax_evaluator.PartNetEPartSegEvaluator)()
    jtrainer = _Trainer(_Loader([{k: (v if k in ("num_scenes", "cls_token") else v[None]) for k, v in b.items()}
                                 for b in batches], ds), _JaxFixed(logits))
    jtrainer.state = SimpleNamespace(params=None, batch_stats=None)
    jhook.trainer = jtrainer
    jhook.eval()
    metric = "ins.mIoU" if kind == "shapenet" else "part.mIoU"
    assert jtrainer.comm_info["current_metric_name"] == hook.trainer.comm_info["current_metric_name"] == metric
    assert got[metric] == pytest.approx(jtrainer.comm_info["current_metric_value"], abs=1e-6)
    assert 0 < got[metric] < 1 and got["overflow"] == 0



def test_jax_partnete_evaluator_scores_every_sample_as_category_0():
    """ROADMAP queue 3 item 14.2: the JAX PartNetE evaluator reads each
    sample's ``cls_token`` from the batch, which the JAX collate does not
    carry (it passes ``category`` alone), so it scores every sample with
    category 0's parts; the port's collate carries ``cls_token`` (-1 for a
    padded scene), and its evaluator refuses a batch without it."""
    from types import SimpleNamespace

    from pointcept_tpu.datasets.utils import point_collate_fn as jax_collate
    from pointcept_tpu_torch.datasets import point_collate_fn
    from pointcept_tpu_torch.engines.hooks import HOOKS

    samples = [dict(coord=np.zeros((5, 3), np.float32), feat=np.zeros((5, 3), np.float32),
                    segment=np.arange(5, dtype=np.int32), offset=np.array([5]), cls_token=tok) for tok in (1, 0)]
    assert "cls_token" not in jax_collate([dict(s) for s in samples], capacity=16)
    got = point_collate_fn([dict(s) for s in samples], capacity=16)
    np.testing.assert_array_equal(got["cls_token"], [1, 0])
    hook = HOOKS.build(dict(type="PartNetEPartSegEvaluator"))
    dataset = SimpleNamespace(categories=["Bottle", "Chair"], num_parts=[3, 4])
    hook.trainer = _Trainer(_Loader([{k: v for k, v in got.items() if k != "cls_token"}], dataset), _FixedLogits([]))
    with pytest.raises(ValueError, match="cls_token"):
        hook.eval()
