"""Point Prompt Training in the port against the JAX package, on the CPU:
PDNorm, `Add`, the collate and the multi-dataset loader, PT-v3m1 with
PDNorm and SpUNet-v1m3 under the three PPT wrappers, one train step of
the tiny PPT config's model, the weight mapping, the multi-dataset trainer
and the tester; and the four faults of the JAX side that the port does not
copy (the tester drops the condition, the loader's length is not its
yield, the outdoor PPT configs' conditions, a v1m3 batch without one).

Small models: the tiny PPT config's SpUNet-v1m3 (widths 8), a PT-v3m1 of
three stages (16-64, patch 64) with decoupled PDNorm on every BatchNorm
and LayerNorm, a ~4,200-point surface scene. The context is 256 wide (the
configs' width, which the reference's PT-v3 PDNorm takes as given). Ports'
weights go to JAX by the JAX converter (SpUNet) or by inverting
`params_from_jax` over the JAX init's shapes (PT-v3's PDNorm, which the
JAX converter does not map), so JAX never runs its init."""

import copy
import random
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_reference_oracle import _surface_scene  # noqa: E402

from pointcept_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pointcept_tpu.datasets.dataloader import MultiDatasetDataloader as JaxMultiDatasetDataloader  # noqa: E402
from pointcept_tpu.datasets.transform import TRANSFORMS as JAX_TRANSFORMS  # noqa: E402
from pointcept_tpu.datasets.utils import point_collate_fn as jax_point_collate_fn  # noqa: E402
from pointcept_tpu.engines.test import TESTERS as JAX_TESTERS  # noqa: E402
from pointcept_tpu.engines.train import TrainState  # noqa: E402
from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.models.modules import PDNorm as JaxPDNorm  # noqa: E402
from pointcept_tpu.models.utils.convert import convert_state_dict  # noqa: E402
from pointcept_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_tpu_torch.datasets import TRANSFORMS, build_dataset, point_collate_fn  # noqa: E402
from pointcept_tpu_torch.datasets.dataloader import MultiDatasetDataloader  # noqa: E402
from pointcept_tpu_torch.datasets.loader import DataLoader  # noqa: E402
from pointcept_tpu_torch.datasets.utils import collate_fn  # noqa: E402
from pointcept_tpu_torch.engines import (  # noqa: E402
    TESTERS, MultiDatasetTrainer, Trainer, default_config_parser, default_setup, make_point_batch,
)
from pointcept_tpu_torch.models import build_model  # noqa: E402
from pointcept_tpu_torch.models.modules import PDNorm  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "configs/synthetic/semseg-ppt-v1m1-0-tiny.py"
SPUNET_PPT = ROOT / "configs/scannet/semseg-ppt-v1m1-0-sc-st-spunet.py"
CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")
PTV3_PD = dict(
    type="PT-v3m1", in_channels=6, order=("z", "z-trans"), stride=(2, 2), enc_depths=(1, 1, 1),
    enc_channels=(16, 32, 64), enc_num_head=(2, 4, 8), enc_patch_size=(64,) * 3, dec_depths=(1, 1),
    dec_channels=(16, 32), dec_num_head=(2, 4), dec_patch_size=(64,) * 2, mlp_ratio=2, drop_path=0.0,
    shuffle_orders=False, serialize_depth=7, pool_capacity_factors=(0.6, 0.6), pdnorm_bn=True, pdnorm_ln=True,
    pdnorm_decouple=True, pdnorm_adaptive=False, pdnorm_conditions=CONDITIONS)
CE = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
CAPACITY = 6144


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tiny_model_cfg(**over):
    return dict(Config.fromfile(str(TINY)).model, **over)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cos(got, want):
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


@pytest.fixture(scope="module")
def scene():
    """A 4,216-point surface scene of 20 labels (a tenth ignored) in
    CAPACITY rows (the tester's capacity too)."""
    grid, feat = _surface_scene(span=50, seed=3, keep=0.4)
    n = len(grid)
    cap = CAPACITY
    rng = np.random.RandomState(1)
    arrays = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                  grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32),
                  segment=np.full(cap, -1, np.int32))
    color = (feat[:, :3] * 255).astype(np.uint8)  # the colors a ScanNet scene stores, normalised as read
    feat = np.concatenate([color.astype(np.float32) / 255, feat[:, 3:]], axis=1).astype(np.float32)
    arrays["coord"][:n] = grid * 0.02
    arrays["feat"][:n] = feat
    arrays["grid_coord"][:n] = grid
    arrays["batch"][:n] = 0
    arrays["segment"][:n] = np.where(rng.rand(n) < 0.1, -1, rng.randint(0, 13, n))
    return dict(arrays=arrays, n=n, grid=grid, feat=feat, color=color)


def _jax_pb(arrays, condition):
    return jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1, condition)


def _port_model(cfg, seed=0):
    """The port's model with seeded weights and non-trivial running
    statistics (means moved by N(0, 0.02), variances by U(0, 0.5): larger
    means would leave SpUNet's ReLUs all off in eval mode)."""
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed + 5)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.add_(torch.from_numpy(rs.randn(*b.shape).astype(np.float32) * 0.02))
            elif name.endswith("running_var"):
                b.add_(torch.from_numpy(rs.rand(*b.shape).astype(np.float32) * 0.5))
    return model


def _port_to_jax(model, jmodel, pb):
    """JAX params and batch stats of `jmodel` holding the port model's
    weights, by the inverse of `params_from_jax` over the init's shapes:
    each leaf is tagged by its index, mapped to its port name, and the
    port's tensor of that name taken back (kernels transposed)."""
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, pb, train=False))
    flat = [jax.tree_util.tree_flatten_with_path(shapes.get(c, {})) for c in ("params", "batch_stats")]
    tags, offset = [], 0
    for leaves, treedef in flat:
        tags.append(jax.tree_util.tree_unflatten(
            treedef, [np.full(s.shape, offset + i, np.float32) for i, (_, s) in enumerate(leaves)]))
        offset += len(leaves)
    index = {int(t.reshape(-1)[0]): name for name, t in params_from_jax(*tags).items()}
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    out, offset = [], 0
    for leaves, treedef in flat:
        values = []
        for i, (path, s) in enumerate(leaves):
            v = sd[index[offset + i]]
            values.append(jnp.asarray(v.T if str(path[-1].key) == "kernel" else v, s.dtype).reshape(s.shape))
        out.append(jax.tree_util.tree_unflatten(treedef, values))
        offset += len(leaves)
    return out


# ------------------------------------------------------------------ PDNorm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "adaptive"])
@pytest.mark.parametrize("decouple", [True, False], ids=["decoupled", "shared"])
@pytest.mark.parametrize("kind", ["bn", "ln"])
def test_pdnorm_matches_jax(kind, decouple, adaptive, train):
    """Each norm kind, decoupled or shared, adaptive or not, in train and
    eval mode: the output (f32, 1e-5) and the active norm's running
    statistics against JAX's PDNorm on the same weights; the other
    conditions' statistics stay bit for bit, and only the active norm and
    the modulation get gradients."""
    rng = np.random.RandomState(7)
    n, c = 96, 8
    x = (rng.randn(n, c) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(n) < 0.8
    context = rng.randn(1, 256).astype(np.float32)
    port = PDNorm(c, CONDITIONS, kind, decouple, adaptive)
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.3))
        for b in port.buffers():
            b.add_(torch.from_numpy(rng.rand(*b.shape).astype(np.float32)))
    port.train(train)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, torch.from_numpy(mask), "S3DIS", torch.from_numpy(context))
    got.square().sum().backward()

    sd = {k: v.numpy() for k, v in before.items()}
    jm = JaxPDNorm(conditions=CONDITIONS, decouple=decouple, adaptive=adaptive, norm_type=kind)
    names = [f"norm{i}" for i in range(3)] if decouple else ["norm"]
    params, stats = {}, {}
    for name, prefix in zip(names, [f"norm.{i}" for i in range(3)] if decouple else ["norm"]):
        params[name] = dict(scale=sd[f"{prefix}.weight"], bias=sd[f"{prefix}.bias"])
        if kind == "bn":
            stats[name] = dict(mean=sd[f"{prefix}.running_mean"], var=sd[f"{prefix}.running_var"])
    if adaptive:
        params["modulation"] = dict(kernel=sd["modulation.1.weight"].T, bias=sd["modulation.1.bias"])
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    want, upd = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), train, "S3DIS", jnp.asarray(context),
                         mutable=["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    after = port.state_dict()
    active = "norm.1" if decouple else "norm"
    for k, v in after.items():
        if "running" not in k:
            continue
        if k.startswith(active):
            jname = "norm1" if decouple else "norm"
            leaf = "mean" if k.endswith("mean") else "var"
            np.testing.assert_allclose(v.numpy(), np.asarray(upd["batch_stats"][jname][leaf]), rtol=1e-6, atol=1e-7)
            assert torch.equal(v, before[k]) != train, k
        else:
            assert torch.equal(v, before[k]), k
    for name, p in port.named_parameters():
        assert (p.grad is not None) == name.startswith((active + ".", "modulation")), name


def test_pdnorm_condition_checks():
    norm = PDNorm(8, CONDITIONS, "ln", adaptive=True)
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="'Waymo' is not among the model's conditions"):
        norm(x, None, "Waymo", torch.zeros(1, 256))
    with pytest.raises(ValueError, match="context"):
        norm(x, None, "ScanNet", None)


# ------------------------------------------------------------------ data


def test_add_and_update_match_jax():
    """`Add` and `Update` (one class under two names) set the keys as the JAX package's."""
    data = dict(coord=np.zeros((3, 3), np.float32), condition="x")
    for name in ("Add", "Update"):
        cfg = dict(type=name, keys_dict={"condition": "ScanNet", "name": "scene0000_00"})
        got = TRANSFORMS.build(copy.deepcopy(cfg))(copy.deepcopy(data))
        want = JAX_TRANSFORMS.build(copy.deepcopy(cfg))(copy.deepcopy(data))
        assert got.keys() == want.keys() and got["condition"] == want["condition"] == "ScanNet"
        assert got["name"] == want["name"]
    assert type(TRANSFORMS.build(dict(type="Add"))) is TRANSFORMS.get("Update")


def _tiny_train_cfg():
    return copy.deepcopy(Config.fromfile(str(TINY)).data.train)


def test_tiny_config_batches_match_jax():
    """The tiny PPT config's first round of batches from the port's
    multi-dataset loader (ScanNet, then Structured3D twice: its loop 2, and
    its one batch again from a restarted loader) and the JAX package's
    first two (its Structured3D loader then runs out), through each
    package's collate at the config's capacity: bit for bit, the condition
    carried."""
    cfg = Config.fromfile(str(TINY))
    port = MultiDatasetDataloader(build_dataset(dict(cfg.data.train)), 4, 0,
                                  collate_fn=lambda b: point_collate_fn(b, capacity=4096), seed=0)
    jcfg = JaxConfig.fromfile(str(TINY))
    jax_dl = JaxMultiDatasetDataloader(jax_build_dataset(dict(jcfg.data.train)), 4, 0,
                                       collate_fn=lambda b: jax_point_collate_fn(b, capacity=4096), seed=0)
    assert port.ratios == jax_dl.ratios == [1, 2]
    got, want = [], []
    for out, dl, count in ((got, port, 3), (want, jax_dl, 2)):
        for batch in dl:
            out.append(batch)
            if len(out) == count:
                break
    assert [b["condition"] for b in got] == ["ScanNet", "Structured3D", "Structured3D"]
    for g, w in zip(got, want + want[1:]):
        assert g["condition"] == w["condition"] and g["num_scenes"] == w["num_scenes"] == 4
        for key in ("coord", "feat", "grid_coord", "batch", "segment"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_collate_refuses_mixed_conditions():
    a = dict(coord=np.zeros((2, 3), np.float32), offset=np.array([2]), condition="ScanNet")
    assert collate_fn([a, dict(a)])["condition"] == "ScanNet"
    with pytest.raises(ValueError, match="mixes the conditions"):
        collate_fn([a, dict(a, condition="Structured3D")])


class _Samples:
    def __init__(self, n, loop, tag):
        self.n, self.loop, self.tag = n, loop, tag

    def __len__(self):
        return self.n * self.loop

    def __getitem__(self, i):
        return (self.tag, i % self.n)


class _Concat:
    def __init__(self, *datasets, loop=1):
        self.datasets, self.loop = list(datasets), loop


@pytest.mark.parametrize("sizes", [((8, 2), (4, 1)), ((9, 3), (2, 1), (5, 2)), ((6, 1), (12, 1))],
                         ids=["s3d2-sc1", "three", "equal"])
def test_multi_dataset_length_is_its_yield(sizes):
    """The port's `len()` is what an epoch yields (the reference's rule:
    the first dataset's batches decide, the others restart), in the ratio
    pattern; the JAX loader's `len()` counts batches it never yields
    (fault 2 of the port's ROADMAP queue 3)."""
    def build(cls):
        concat = _Concat(*[_Samples(n, r, t) for t, (n, r) in enumerate(sizes)])
        return cls(concat, 2, 0, collate_fn=lambda b: b, seed=0)

    port = build(MultiDatasetDataloader)
    batches = list(port)
    assert len(port) == len(batches)
    pattern = [t for t, (_, r) in enumerate(sizes) for _ in range(r)]
    assert [b[0][0] for b in batches] == (pattern * len(batches))[:len(batches)]
    assert all(len({s[0] for s in b}) == 1 for b in batches)
    jax_dl = build(JaxMultiDatasetDataloader)
    yielded = sum(1 for _ in jax_dl)
    if sizes == ((6, 1), (12, 1)):
        # ratios 1: the JAX count holds (each loader once); the port's epoch is
        # the first dataset's three batches, each beside one of the second's
        assert len(jax_dl) == yielded == 9
        assert len(port) == 6
    else:
        assert len(jax_dl) != yielded, (len(jax_dl), yielded)


# ------------------------------------------------------------------ models


def _spunet_to_jax(model):
    """A port SpUNet-based PPT model's weights as JAX trees (the JAX
    converter for the backbone, the wrapper's leaves by name)."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats, unmatched = convert_state_dict(sd, "SpUNet-v1m1")
    assert unmatched == []
    for key, value in sd.items():
        if key.startswith("backbone."):
            continue
        if key == "embedding_table.weight":
            params["embedding_table"] = {"embedding": value}
        elif key in ("class_embedding", "logit_scale"):
            params[key] = value
        else:
            module, leaf = key.rsplit(".", 1)
            params.setdefault(module, {})["kernel" if leaf == "weight" else leaf] = value.T if leaf == "weight" \
                else value
    return params, stats


def _wrapped(kind, backbone):
    width = 16 if backbone["type"].startswith("PT-v3") else backbone.get("channels", (8,))[-1]
    common = dict(backbone=backbone, criteria=CE, backbone_out_channels=width,
                  conditions=("Structured3D", "ScanNet", "S3DIS"))
    if kind == "v1m1":
        return dict(common, type="PPT-v1m1", context_channels=256, clip_embed_dim=24)
    if kind == "v1m2":
        return dict(common, type="PPT-v1m2", context_channels=256, num_classes=(25, 20, 13))
    return dict(common, type="PPT-v1m3", text_dim=24)


def _spunet_backbone(adaptive=True, decouple=True, pd=True, levels=4):
    """The tiny config's SpUNet-v1m3 (8 wide) at the three default
    conditions and a 256-wide context (SpUNet-v1m1 without `pd`), at
    `levels` resolution levels."""
    bb = dict(_tiny_model_cfg()["backbone"], conditions=CONDITIONS, context_channels=256, norm_adaptive=adaptive,
              norm_decouple=decouple, channels=(8,) * 2 * levels, layers=(1,) * 2 * levels)
    if not pd:
        bb = {k: v for k, v in bb.items() if k not in ("conditions", "norm_adaptive", "norm_decouple")}
        bb["type"] = "SpUNet-v1m1"
    return bb


def _jax_eval(model, cfg, arrays, condition):
    """JAX's eval logits and loss of `cfg` on the port model's weights, and
    its jitted forward ``fwd(params, stats, pb)`` (compiled once a shape)."""
    jm = jax_build_model(cfg)
    pb = _jax_pb(arrays, condition)
    params, stats = _port_to_jax(model, jm, pb)
    fwd = jax.jit(lambda p, b, x: jm.apply({"params": p, "batch_stats": b}, x, train=False))
    out = fwd(params, stats, pb)
    return dict(params=params, stats=stats, fwd=fwd, logits=np.asarray(out["seg_logits"]), loss=float(out["loss"]))


@pytest.fixture(scope="module")
def spunet_ref(scene):
    """PPT-v1m1 over the SpUNet-v1m3 of `configs/scannet/semseg-ppt-v1m1-0-sc-st-spunet.py`
    (adaptive, decoupled) at the tiny config's widths: the port model and
    JAX's eval logits and loss at ScanNet."""
    cfg = _wrapped("v1m1", _spunet_backbone())
    model = _port_model(cfg)
    return dict(cfg=cfg, model=model, **_jax_eval(model, cfg, scene["arrays"], "ScanNet"))


def _check_logits(res, want, n, classes, loss):
    got = res["seg_logits"].numpy()[:n]
    want = want[:n]
    assert got.shape == want.shape == (n, classes) and np.abs(want).max() > 0
    assert _rel(got, want) < 1e-2 and (got.argmax(1) == want.argmax(1)).mean() > 0.99
    assert abs(float(res["loss"]) - loss) < 1e-3 * abs(loss)


@pytest.mark.parametrize("kind", ["v1m1", "v1m2", "v1m3"])
def test_wrappers_over_spunet_match_jax(scene, spunet_ref, kind):
    """Each wrapper over SpUNet: v1m1 over SpUNet-v1m3 at ScanNet (20
    classes), v1m2 over a two-level SpUNet-v1m3 with one shared adaptive
    norm at S3DIS (its third head, 13 classes), v1m3 over a two-level
    SpUNet-v1m1 (it has no context) at S3DIS: logits < 1e-2 relative,
    argmax > 0.99, the loss within 1e-3 relative (f32 stream, bf16 conv
    operands on both sides)."""
    arrays, n = scene["arrays"], scene["n"]
    if kind == "v1m1":
        res = spunet_ref["model"](make_point_batch(arrays, 1, device="cpu", condition="ScanNet"))
        _check_logits(res, spunet_ref["logits"], n, 20, spunet_ref["loss"])
        return
    backbone = (_spunet_backbone(decouple=False, levels=2) if kind == "v1m2"
                else _spunet_backbone(pd=False, levels=2))
    cfg = _wrapped(kind, backbone)
    model = _port_model(cfg)
    want = _jax_eval(model, cfg, arrays, "S3DIS")
    res = model(make_point_batch(arrays, 1, device="cpu", condition="S3DIS"))
    _check_logits(res, want["logits"], n, 13, want["loss"])


@pytest.fixture(scope="module")
def ptv3_ref(scene):
    """PPT-v1m1 over PT-v3m1 with decoupled PDNorm on every norm: the port
    model, its weights in JAX and JAX's eval logits and loss at ScanNet."""
    cfg = _wrapped("v1m1", PTV3_PD)
    model = _port_model(cfg)
    return dict(cfg=cfg, model=model, **_jax_eval(model, cfg, scene["arrays"], "ScanNet"))


def test_ptv3_pdnorm_under_v1m1_matches_jax(scene, ptv3_ref):
    """PT-v3m1's PDNorm at every BatchNorm and LayerNorm (stem, cpe, norm1,
    norm2, pooling, unpooling) under PPT-v1m1: logits < 1e-2 relative,
    argmax > 0.99, the loss within 1e-3 relative (the bounds of
    tests/test_torch_port_ptv3.py)."""
    res = ptv3_ref["model"](make_point_batch(scene["arrays"], 1, device="cpu", condition="ScanNet"))
    _check_logits(res, ptv3_ref["logits"], scene["n"], 20, ptv3_ref["loss"])
    sd = ptv3_ref["model"].state_dict()
    for name in ("backbone.embedding.stem.norm.norm.2.running_var", "backbone.enc.enc0.block0.cpe.2.norm.0.weight",
                 "backbone.enc.enc1.down.norm.0.norm.1.running_mean", "backbone.dec.dec0.up.proj_skip.1.norm.2.bias",
                 "backbone.dec.dec1.block0.norm2.0.norm.1.weight", "embedding_table.weight", "class_embedding",
                 "logit_scale", "proj_head.weight"):
        assert name in sd, name


def test_params_from_jax_round_trips(ptv3_ref, spunet_ref):
    """`params_from_jax` gives back the port's state dict bit for bit from
    the JAX trees of PPT-v1m1 over PT-v3 (PDNorm ``norm.{i}``) and over
    SpUNet-v1m3 (``bns.{i}``, ``modulation.1``); SpUNet's trees also by the
    JAX converter's way (`convert_spunet`), and v1m2's heads."""
    for model, (params, stats) in (
            (ptv3_ref["model"], (ptv3_ref["params"], ptv3_ref["stats"])),
            (spunet_ref["model"], (spunet_ref["params"], spunet_ref["stats"])),
            (spunet_ref["model"], _spunet_to_jax(spunet_ref["model"])),
            (_port_model(_tiny_model_cfg()), _spunet_to_jax(_port_model(_tiny_model_cfg()))),
            (_port_model(_wrapped("v1m2", _spunet_backbone())), _spunet_to_jax(
                _port_model(_wrapped("v1m2", _spunet_backbone()))))):
        back = params_from_jax(jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, stats))
        sd = model.state_dict()
        assert set(back) == set(sd)
        for name, v in back.items():
            np.testing.assert_array_equal(v.numpy(), sd[name].numpy(), err_msg=name)
    tiny = _port_model(_tiny_model_cfg())
    assert "backbone.enc.0.block0.bn1.bns.1.running_var" in tiny.state_dict()
    assert "backbone.conv_input.1.modulation.1.weight" in tiny.state_dict()


# ------------------------------------------------------------------ training


def _tiny_batch():
    """One collated batch of the tiny config's ScanNet sub-dataset."""
    cfg = Config.fromfile(str(TINY))
    dl = DataLoader(build_dataset(dict(cfg.data.train.datasets[0])), batch_size=4, shuffle=True,
                    collate_fn=lambda b: point_collate_fn(b, capacity=4096), drop_last=True, seed=0)
    return next(iter(dl))


def _grads(model, arrays):
    model.train()
    model.zero_grad(set_to_none=True)
    res = model(make_point_batch(arrays, arrays["num_scenes"], device="cpu"))
    res["loss"].backward()
    return float(res["loss"]), {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}


def test_tiny_config_train_step_matches_jax():
    """One train step of the tiny PPT config's model (PPT-v1m1 over
    SpUNet-v1m3, adaptive decoupled PDNorm) on a ScanNet batch: the loss
    within 2e-2 relative; every gradient within 5e-2 relative L2 and cosine
    > 0.999, or twice the noise floor where that is above them. The floor
    of a tensor is the largest of the port's and JAX's own (each
    framework's step on features scaled by 1 + 1e-6 N(0, 1), two draws,
    against its step on the batch; one draw's floor varies 3-5x from the
    next): the coarse levels of four scenes of ~1,000 points hold a few
    hundred rows under train-mode BatchNorm, and there JAX's own floor
    (measured up to 8.5e-3 in 1 - cosine) is above the port's (1.5e-3)
    and above port against JAX (4.1e-3). The tensors without a port
    gradient (the other condition's norms) are exactly zero in JAX; the
    running statistics of ScanNet's norms are JAX's (1e-3), the others'
    bit for bit."""
    arrays = _tiny_batch()
    assert arrays["condition"] == "ScanNet"
    model = _port_model(_tiny_model_cfg())
    params, stats = _spunet_to_jax(model)
    jm = jax_build_model(_tiny_model_cfg())
    def batch(feat):
        return jax_point_batch({k: jnp.asarray(v) for k, v in dict(arrays, feat=feat).items()
                                if k not in ("num_scenes", "condition")}, arrays["num_scenes"], "ScanNet")

    def loss_fn(p, pb):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, pb, train=True, mutable=["batch_stats"])
        return out["loss"], upd["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    # fault 5: at the init's zero head bias, rows whose SpUNet features are
    # all zero project to zero; JAX's gradient of the head is NaN there, the
    # port's is finite (those rows add nothing)
    _, jgrads = step(params, batch(arrays["feat"]))
    assert np.isnan(np.asarray(jgrads["proj_head"]["kernel"])).any()
    head = _port_model(_tiny_model_cfg())
    _, zero_bias = _grads(head, arrays)
    assert all(np.isfinite(g).all() for g in zero_bias.values())
    # the comparison, at a head bias of N(0, 0.1) on both sides (no zero row)
    with torch.no_grad():
        model.proj_head.bias.copy_(torch.randn(512, generator=torch.Generator().manual_seed(3)) * 0.1)
    params["proj_head"]["bias"] = model.proj_head.bias.detach().numpy().copy()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, got = _grads(model, arrays)
    (jloss, jstats), jgrads = step(params, batch(arrays["feat"]))
    assert abs(loss - float(jloss)) < 2e-2 * abs(float(jloss)), (loss, float(jloss))

    def named(tree):
        return {n: g.numpy() for n, g in params_from_jax(jax.tree_util.tree_map(np.asarray, tree), {}).items()}

    want = named(jgrads)
    with torch.no_grad():
        head.proj_head.bias.copy_(model.proj_head.bias)
    floors = []  # (port, JAX) gradients on features nudged by two draws
    for seed in (0, 1):
        feat = arrays["feat"] * (1 + 1e-6 * np.random.RandomState(seed).randn(*arrays["feat"].shape)).astype(
            np.float32)
        floors.append((_grads(head, dict(arrays, feat=feat))[1], named(step(params, batch(feat))[1])))
    bad = {}
    for name, w in want.items():
        if name not in got:
            assert not np.any(w), name
            assert ".bns.0." not in name, name  # ScanNet's norms are trained
            continue
        g = got[name]
        fl = max(max(_rel_l2(pf[name], g), _rel_l2(jf[name], w)) for pf, jf in floors)
        fl_cos = min(min(_cos(pf[name], g), _cos(jf[name], w)) for pf, jf in floors)
        if not np.any(w) and not np.any(g):
            continue
        err, cos = _rel_l2(g, w), _cos(g, w)
        if not (err < max(5e-2, 2 * fl) and cos > min(0.999, 1 - 2 * (1 - fl_cos))):
            bad[name] = (err, cos, fl, fl_cos)
    assert not bad, bad
    assert set(got) <= set(want)
    assert any(".bns.0." in n for n in got) and not any(".bns.1." in n for n in got)
    after = model.state_dict()
    jsd = params_from_jax(params, jax.tree_util.tree_map(np.asarray, jstats))
    for name, v in after.items():
        if "running" not in name:
            continue
        if ".bns.0." in name:
            np.testing.assert_allclose(v.numpy(), jsd[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)
        else:
            assert torch.equal(v, before[name]), name
    # the context row of ScanNet (the tiny config's condition 0) alone has a gradient
    table = got["embedding_table.weight"]
    assert np.any(table[0]) and not np.any(table[1])


def test_multi_dataset_trainer_runs_tiny_config(tmp_path):
    """`MultiDatasetTrainer` on the tiny config, on the CPU: its length is
    the steps it runs (the ratio pattern ScanNet, Structured3D,
    Structured3D), every step's batch holds one condition, finite losses,
    and the val pass carries ScanNet."""
    cfg = default_setup(default_config_parser(str(TINY), dict(save_path=str(tmp_path / "run"), epoch=1,
                                                               eval_epoch=1)))
    seen = []
    trainer = MultiDatasetTrainerProbe(cfg, device="cpu", seen=seen)
    trainer.train()
    assert len(trainer.train_loader) == len(seen) == 6
    assert seen == ["ScanNet", "Structured3D", "Structured3D"] * 2
    assert np.isfinite(trainer.comm_info["eval_result"]["mIoU"])
    assert trainer.eval_conditions == {"ScanNet"}


class MultiDatasetTrainerProbe(MultiDatasetTrainer):
    """The trainer, recording each step's and each eval batch's condition."""

    def __init__(self, cfg, device=None, seen=None):
        self.seen, self.eval_conditions = seen, set()
        super().__init__(cfg, device=device)

    def run_step(self):
        self.seen.append(self.comm_info["input_dict"]["condition"])
        super().run_step()

    def eval_step(self, batch):
        self.eval_conditions.add(batch["condition"])
        return super().eval_step(batch)


# ------------------------------------------------------------------ faults


def _write_scannet_scene(root, scene):
    """The scene in ScanNet's layout under ``root/val/scene0000_00``, one
    point at each 2 cm voxel's centre (the test section's GridSample
    shifts them and sorts them into fragments)."""
    n = scene["n"]
    d = root / "val" / "scene0000_00"
    d.mkdir(parents=True)
    np.save(d / "coord.npy", (scene["grid"] * 0.02 + 0.01).astype(np.float32))
    np.save(d / "color.npy", scene["color"])
    np.save(d / "normal.npy", scene["feat"][:, 3:])
    np.save(d / "segment20.npy", scene["arrays"]["segment"][:n].astype(np.int16))


def _tester_cfg(tmp_path, backbone):
    """`configs/scannet/semseg-ppt-v1m1-0-sc-st-spunet.py` (its test section:
    ``Add`` of ScanNet in `post_transform`) over `backbone`."""
    path = tmp_path / "ppt_test.py"
    path.write_text(f'_base_ = ["{SPUNET_PPT}"]\n'
                    f"model = dict(backbone=dict(_delete_=True, **{backbone!r}), backbone_out_channels="
                    f"{_wrapped('v1m1', backbone)['backbone_out_channels']}, clip_embed_dim=24)\n")
    options = dict(save_path=str(tmp_path / "out"), weight=str(tmp_path / "w.pth"), point_capacity_test=CAPACITY,
                   num_worker=0, enable_amp=False, **{"data.test.data_root": str(tmp_path / "data")})
    return path, options


@pytest.mark.parametrize("backbone", ["spunet", "ptv3"])
def test_tester_carries_the_condition(tmp_path, scene, spunet_ref, ptv3_ref, backbone):
    """Fault 1: the JAX tester's forward of a PPT config's fragment fails
    (its `make_point_batch` passes no condition), while the port's tester
    carries the fragments' ``condition`` into every forward and matches
    the JAX model with the condition passed by hand: SpUNet's per-fragment
    path and PT-v3's grouped path, their summed softmax against the sum of
    JAX's softmax over the same fragments (< 1e-2, argmax > 0.99)."""
    ref = spunet_ref if backbone == "spunet" else ptv3_ref
    _write_scannet_scene(tmp_path / "data", scene)
    path, options = _tester_cfg(tmp_path, ref["cfg"]["backbone"])
    torch.save({"state_dict": ref["model"].state_dict()}, tmp_path / "w.pth")
    cfg = default_config_parser(str(path), options)
    tester = TESTERS.build(dict(cfg.test, cfg=cfg, device="cpu"))
    assert tester._fragment_geometry_ok() == (backbone == "ptv3")
    tester.test()
    st = tester.scene_stats[0]
    assert st["dropped"] == 0 and (st["groups"] is not None) == (backbone == "ptv3")
    pred = np.load(tmp_path / "out" / "result" / "scene0000_00_pred.npy")

    jcfg = JaxConfig.fromfile(str(path))
    jcfg.merge_from_dict(dict(options, save_path=str(tmp_path / "jax")))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=ref["params"], batch_stats=ref["stats"], opt_state=())
    jtester = JAX_TESTERS.build(dict(type="SemSegTester", cfg=jcfg, model=jax_build_model(dict(jcfg.model)),
                                     state=state))
    fragments = tester.test_dataset[0]["fragment_list"]
    assert len(fragments) == st["fragments"] and all(f["condition"] == "ScanNet" for f in fragments)
    want = np.zeros_like(pred)
    for fragment in fragments:
        batch = jtester.fragment_batch(copy.deepcopy(fragment))
        assert batch["condition"] == "ScanNet"  # the collate keeps it; the forward drops it
        feed = {k: jnp.asarray(v) for k, v in batch.items() if k not in ("num_scenes", "condition")}
        with pytest.raises(AssertionError, match="unknown condition None"):
            jtester.infer(state, feed)
        # an all-ignored segment keeps the reference batch's structure (one compile)
        feed["segment"] = jnp.full((CAPACITY,), -1, jnp.int32)
        logits = ref["fwd"](ref["params"], ref["stats"], jax_point_batch(feed, 1, "ScanNet"))["seg_logits"]
        index = np.asarray(fragment["index"])
        want[index] += np.asarray(jax.nn.softmax(logits, axis=-1))[: len(index)]
    assert np.abs(pred - want).max() < 1e-2 and (pred.argmax(1) == want.argmax(1)).mean() > 0.99


OUTDOOR_PPT = ["nuscenes/semseg-ppt-v1m1-0-nu-sk-wa-spunet.py", "semantic_kitti/semseg-ppt-v1m1-0-sk-nu-wa-spunet.py",
               "nuscenes/semseg-ppt-v1m2-0-nu-sk-wa-spunet.py", "nuscenes/semseg-ppt-v1m2-1-nu-sk-wa-spunet-submit.py",
               "semantic_kitti/semseg-ppt-v1m2-0-sk-nu-wa-spunet.py",
               "semantic_kitti/semseg-ppt-v1m2-0-sk-nu-wa-spunet-submit.py"]


@pytest.mark.parametrize("path", OUTDOOR_PPT)
def test_outdoor_ppt_configs_refuse_their_conditions(tmp_path, path):
    """Fault 3: the outdoor PPT configs keep their `_base_`'s indoor data
    (Structured3D and ScanNet conditions, 6 channels) under models of the
    outdoor conditions. The port's trainer refuses them before anything is
    built, naming both lists."""
    cfg = default_config_parser(str(ROOT / "configs" / path), dict(save_path=str(tmp_path / "run")))
    assert set(cfg.model.conditions) == {"SemanticKITTI", "nuScenes", "Waymo"}
    with pytest.raises(ValueError, match=r"\['ScanNet', 'Structured3D'\].*'SemanticKITTI'") as info:
        Trainer(cfg, device="cpu")
    assert "nuScenes" in str(info.value) and "Waymo" in str(info.value)


def test_v1m3_batch_without_condition_raises(scene):
    """Fault 4: the PPT-v1m3 configs' pipelines add no condition; the port
    raises at the forward, as the JAX wrapper asserts, and adds none of its
    own. Their ScanNet200 files keep the default 25 / 20 / 13 class lists."""
    cfg = Config.fromfile(str(ROOT / "configs/sonata/semseg-sonata-v1m1-0d-scannet-ppt.py"))
    steps = [t["type"] for t in cfg.data.train.transform]
    assert "Add" not in steps and "Update" not in steps
    s200 = Config.fromfile(str(ROOT / "configs/sonata/semseg-sonata-v1m1-1d-scannet200-ppt.py"))
    assert s200.data.num_classes == 200 and "class_names" not in s200.model
    model = _port_model(_wrapped("v1m3", _spunet_backbone(pd=False)))
    arrays = scene["arrays"]
    with pytest.raises(ValueError, match="carries no condition"):
        model(make_point_batch(arrays, 1, device="cpu"))
    with pytest.raises(ValueError, match="'Waymo' is not among"):
        model(make_point_batch(arrays, 1, device="cpu", condition="Waymo"))
    assert model(make_point_batch(arrays, 1, device="cpu", condition="S3DIS"))["seg_logits"].shape[1] == 13
