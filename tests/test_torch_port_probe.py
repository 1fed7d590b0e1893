"""Sonata's downstream configs in the port against the JAX package, on the CPU.

`DefaultSegmentorV2` over an ``enc_mode`` PT-v3m2 (the linear probe): the
up-cast of the skip chain, the frozen backbone's train step, the loading of
a Sonata checkpoint written by the port's `CheckpointSaver`, the
data-efficient datasets (`lr_file`, `la_file`) and the transforms that keep
``sampled_index``, and the tester on an ``enc_mode`` config. Each JAX fault
this slice meets is compared around and named by a test of its own.

Small model: 3 stages (32, 64, 128 channels, head dim 16), patch 128, the
gather engine (Sonata's), one block a stage, on the 13k-point surface scene
of `tests/test_reference_oracle.py`."""

import copy
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

from pointcept_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pointcept_tpu.datasets.transform import TRANSFORMS as JAX_TRANSFORMS  # noqa: E402
from pointcept_tpu.engines.test import TESTERS as JAX_TESTERS  # noqa: E402
from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_tpu.utils.optimizer import build_optimizer as jax_build_optimizer  # noqa: E402
from pointcept_tpu.utils.scheduler import build_scheduler as jax_build_scheduler  # noqa: E402
from pointcept_tpu_torch.datasets import TRANSFORMS, build_dataset, synthesize_scene  # noqa: E402
from pointcept_tpu_torch.engines import TESTERS, build_train_step, make_point_batch  # noqa: E402
from pointcept_tpu_torch.engines.hooks.misc import CheckpointLoader, CheckpointSaver  # noqa: E402
from pointcept_tpu_torch.models import build_model  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.utils import build_optimizer, build_scheduler  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402
from pointcept_tpu_torch.utils.logger import get_root_logger  # noqa: E402

# the linear probe's schedule (configs/sonata/semseg-sonata-v1m1-0a-scannet-lin.py)
OPTIMIZER = dict(type="AdamW", lr=0.002, weight_decay=0.02)
PARAM_DICTS = [dict(keyword="block", lr=0.0002)]
SCHEDULER = dict(type="OneCycleLR", max_lr=[0.002, 0.0002], pct_start=0.05, anneal_strategy="cos",
                 div_factor=10.0, final_div_factor=1000.0)
ENC = (32, 64, 128)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _backbone(**extra):
    bb = dict(type="PT-v3m2", in_channels=6, order=("z", "z-trans", "hilbert", "hilbert-trans"),
              stride=(2, 2), enc_depths=(1, 1, 1), enc_channels=ENC, enc_num_head=(2, 4, 8),
              enc_patch_size=(128,) * 3, mlp_ratio=2, drop_path=0.0, shuffle_orders=False,
              serialize_depth=7, pool_capacity_factors=(0.5, 0.5), conv_engine="gather", enc_mode=True)
    bb.update(extra)
    return bb


def _probe_cfg(up_cast_level=0, freeze=False, num_classes=13, **extra):
    return dict(type="DefaultSegmentorV2", num_classes=num_classes, backbone_out_channels=sum(ENC),
                backbone=_backbone(**extra), freeze_backbone=freeze, up_cast_level=up_cast_level,
                criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])


def _labelled_scene():
    grid, feat = _surface_scene(span=60, seed=3)
    n = len(grid)
    cap = ((n + 255) // 256) * 256 + 256
    rng = np.random.RandomState(9)
    arrays = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                  grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32),
                  segment=np.full(cap, -1, np.int32))
    arrays["coord"][:n] = grid * 0.02
    arrays["feat"][:n] = feat
    arrays["grid_coord"][:n] = grid
    arrays["batch"][:n] = 0
    arrays["segment"][:n] = np.where(rng.rand(n) < 0.1, -1, rng.randint(0, 12, n))
    return arrays


@pytest.fixture(scope="module")
def weights():
    """JAX weights of the probe at every level, random (seed 0) with
    non-trivial running statistics."""
    arrays = _labelled_scene()
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    out = dict(arrays=arrays, pb=pb)
    for level in (0, 2):
        model = jax_build_model(_probe_cfg(level))
        variables = jax.jit(lambda r: model.init(r, pb, train=False))({"params": jax.random.PRNGKey(0)})
        rs = np.random.RandomState(5)
        out[level] = dict(
            params=jax.tree_util.tree_map(np.asarray, variables["params"]),
            stats=jax.tree_util.tree_map(lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5,
                                         variables["batch_stats"]))
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cos(got, want):
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


# ------------------------------------------------------------ up-cast


@pytest.mark.parametrize("level", [0, 2])
def test_up_cast_logits_match_jax(weights, level):
    """The probe's eval logits: the full skip chain (level 0, 32 + 64 + 128
    channels) and two levels. f32 stream with bf16 conv and attention
    operands: < 1e-2 relative, argmax > 0.99 (the bounds of
    tests/test_torch_port_ptv3.py)."""
    w = weights[level]
    model = jax_build_model(_probe_cfg(level))
    res = jax.jit(lambda p, b: model.apply({"params": p, "batch_stats": b}, weights["pb"], train=False))(
        w["params"], w["stats"])
    want = np.asarray(res["seg_logits"], np.float32)
    port = build_model(_probe_cfg(level), device="cpu")
    assert port.seg_head.weight.shape == (13, sum(ENC[3 - 1 - (level or 2):]))
    port.load_state_dict(params_from_jax(w["params"], w["stats"]), strict=True)
    got = port(make_point_batch(weights["arrays"], 1, device="cpu"))
    v = weights["arrays"]["batch"] >= 0
    g, wt = got["seg_logits"].numpy()[v], want[v]
    assert got["feat"].shape[1] == port.seg_head.weight.shape[1]
    err, agree = _rel(g, wt), (g.argmax(1) == wt.argmax(1)).mean()
    assert np.isfinite(g).all() and err < 1e-2 and agree > 0.99, (err, agree)


def test_head_width_comes_from_the_backbone(caplog):
    """Fault 4: the Sonata probe config's ``backbone_out_channels=1328``
    is not the up-cast's 48 + 96 + 192 + 384 + 512 = 1,232 (JAX's
    ``nn.Dense`` infers its width and never notices). The port takes the
    backbone's width and logs both numbers; a decoder backbone keeps the
    strict check."""
    cfg = Config.fromfile(str(Path(__file__).resolve().parents[1] / "configs/sonata/semseg-sonata-v1m1-0a-scannet-lin.py"))
    assert cfg.model.backbone_out_channels == 1328 and sum(cfg.model.backbone.enc_channels) == 1232
    cfg = _probe_cfg()
    cfg["backbone_out_channels"] = 1328
    logger = get_root_logger()
    logger.propagate, old = True, logger.propagate
    try:
        with caplog.at_level("WARNING"):
            model = build_model(cfg, device="cpu")
    finally:
        logger.propagate = old
    assert model.seg_head.weight.shape[1] == sum(ENC)
    assert "1328" in caplog.text and str(sum(ENC)) in caplog.text
    dec = _probe_cfg(enc_mode=False, dec_depths=(1, 1), dec_channels=(32, 64), dec_num_head=(2, 4),
                     dec_patch_size=(128, 128))
    with pytest.raises(ValueError, match="backbone_out_channels"):
        build_model(dec, device="cpu")


# ------------------------------------------------------------ frozen probe step


@pytest.fixture(scope="module")
def jax_probe_step(weights):
    """One JAX train step of the linear probe (freeze by stop_gradient):
    loss, grads, the new running statistics."""
    w = weights[0]
    model = jax_build_model(_probe_cfg(0, freeze=True))

    def loss_fn(params):
        out, upd = model.apply({"params": params, "batch_stats": w["stats"]}, weights["pb"], train=True,
                               rngs={"shuffle": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                               mutable=["batch_stats", "diagnostics"])
        return out["loss"], upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(w["params"])
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(loss=float(loss), grads=tree(grads), stats=tree(stats))


def _jax_update(params, grads, weight_decay):
    opt = dict(OPTIMIZER, weight_decay=weight_decay)
    tx = jax_build_optimizer(opt, params, jax_build_scheduler(SCHEDULER, total_steps=1000), PARAM_DICTS)
    updates, _ = tx.update(grads, tx.init(params), params)
    return jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))


@pytest.fixture(scope="module")
def port_probe_step(weights):
    w = weights[0]
    model = build_model(_probe_cfg(0, freeze=True), device="cpu")
    model.load_state_dict(params_from_jax(w["params"], w["stats"]), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = build_optimizer(OPTIMIZER, model, PARAM_DICTS)
    scheduler = build_scheduler(SCHEDULER, optimizer, total_steps=1000)
    step = build_train_step(model, optimizer, scheduler)
    res = step(make_point_batch(weights["arrays"], 1, device="cpu"), torch.Generator().manual_seed(0))
    after = {k: v.clone() for k, v in model.state_dict().items()}
    feat = model(make_point_batch(weights["arrays"], 1, device="cpu"))["feat"]  # train mode, as the step left it
    return dict(model=model, before=before, after=after, optimizer=optimizer, loss=float(res["loss"]), feat=feat)


def test_frozen_probe_step_matches_jax(weights, jax_probe_step, port_probe_step):
    """AdamW at the probe's wd 0.02: the port's backbone weights are
    bit-identical after the step (they require no gradient, sit in no
    optimizer group, and no graph runs through the backbone), its running
    statistics equal JAX's (rtol 1e-3, as tests/test_torch_port_train.py),
    and the seg head's update is JAX's optimizer applied to the port's
    gradient (rtol 1e-6), with that gradient within 5e-2 relative L2 and
    cosine 0.999 of JAX's. The backbone is compared with JAX's at wd 0,
    where JAX too leaves it as it was."""
    w, port, want = weights[0], port_probe_step, jax_probe_step
    model = port["model"]
    assert abs(port["loss"] - want["loss"]) / want["loss"] < 2e-2, (port["loss"], want["loss"])
    grouped = {id(p) for g in port["optimizer"].param_groups for p in g["params"]}
    names = {n for n, p in model.named_parameters() if id(p) in grouped}
    assert names == {"seg_head.weight", "seg_head.bias"}
    assert port["feat"].grad_fn is None and not port["feat"].requires_grad
    assert all(p.grad is None for p in model.backbone.parameters())
    sd = port["after"]
    initial = params_from_jax(w["params"], w["stats"])
    jax_wd0 = params_from_jax(_jax_update(w["params"], want["grads"], 0.0), want["stats"])
    for name, value in sd.items():
        if not name.startswith("backbone.") or name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        assert torch.equal(value, port["before"][name]), name
        assert torch.equal(value, jax_wd0[name]), name
    moved = 0
    for name, value in sd.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), jax_wd0[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)
            moved += int(not torch.equal(value, initial[name]))
    assert moved > 0  # BatchNorm statistics move in train mode, frozen or not

    jgrads = params_from_jax(want["grads"], {})
    for name in ("seg_head.weight", "seg_head.bias"):
        g, jg = model.get_parameter(name).grad.numpy(), jgrads[name].numpy()
        assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 5e-2 and _cos(g, jg) > 0.999, name
    port_grads = jax.tree_util.tree_map(np.zeros_like, w["params"])
    port_grads["seg_head"] = dict(kernel=model.seg_head.weight.grad.numpy().T,
                                  bias=model.seg_head.bias.grad.numpy())
    want_head = params_from_jax(_jax_update(w["params"], port_grads, OPTIMIZER["weight_decay"]), {})
    for name in ("seg_head.weight", "seg_head.bias"):
        assert not torch.equal(sd[name], initial[name])
        np.testing.assert_allclose(sd[name].numpy(), want_head[name].numpy(), rtol=1e-6, atol=1e-8, err_msg=name)


def test_jax_frozen_backbone_decays(weights, jax_probe_step):
    """Fault 1: JAX freezes with `stop_gradient`, and AdamW's decoupled
    decay still shrinks the zero-gradient backbone: at the probe's wd 0.02
    every nonzero backbone weight moves by lr * wd * w in the first step."""
    w = weights[0]
    before = params_from_jax(w["params"], {})
    after = params_from_jax(_jax_update(w["params"], jax_probe_step["grads"], OPTIMIZER["weight_decay"]), {})
    name = "backbone.enc.enc0.block0.attn.qkv.weight"
    assert not np.abs(jax_probe_step["grads"]["backbone_module"]["enc0_block0"]["attn"]["qkv"]["kernel"]).any()
    lr0 = SCHEDULER["max_lr"][1] / SCHEDULER["div_factor"]  # "block" group, OneCycle step 0
    shrink = after[name].numpy() / before[name].numpy()
    np.testing.assert_allclose(shrink, 1.0 - lr0 * OPTIMIZER["weight_decay"], rtol=1e-6)
    assert not np.array_equal(after[name].numpy(), before[name].numpy())


def test_jax_trainable_keywords_moves_frozen_tensors():
    """Fault 2: JAX's ``trainable_keywords`` wraps the optimizer in
    `optax.masked`, which passes the updates of the unmasked (frozen)
    tensors through unchanged: a frozen weight of 1.0 with gradient 0.5
    becomes 1.5 (moved by its raw gradient at lr 1). The port freezes the
    other tensors in the model instead: the same step leaves its backbone
    weight as it was (tests/test_torch_port_lora.py)."""
    params = {"backbone": {"w": jnp.ones((2,))}, "seg_head": {"w": jnp.ones((2,))}}
    grads = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.5), params)
    tx = jax_build_optimizer(dict(type="AdamW", lr=1e-3, weight_decay=0.0, trainable_keywords=("seg_head",)),
                             params, lambda step: 1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    np.testing.assert_allclose(np.asarray(new["backbone"]["w"]), 1.5)
    assert np.all(np.asarray(new["seg_head"]["w"]) < 1.0)
    model = torch.nn.ModuleDict(dict(backbone=torch.nn.Linear(2, 2), seg_head=torch.nn.Linear(2, 2)))
    before = model.backbone.weight.detach().clone()
    optimizer = build_optimizer(dict(type="AdamW", lr=1e-3, weight_decay=0.0, trainable_keywords=("seg_head",)),
                                model)
    assert not model.backbone.weight.requires_grad and model.seg_head.weight.requires_grad
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    optimizer.step()
    assert torch.equal(model.backbone.weight, before)


# ------------------------------------------------------------ checkpoint loading

SONATA = dict(type="Sonata-v1m1", backbone=_backbone(mask_token=True), head_in_channels=sum(ENC),
              head_hidden_channels=64, head_embed_channels=32, head_num_prototypes=64, num_global_view=2,
              num_local_view=2, up_cast_level=2)


def _fake_trainer(model, save_path, weight=None):
    cfg = Config(dict(save_path=str(save_path), weight=weight))
    optimizer = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-3)
    return SimpleNamespace(model=model, cfg=cfg, logger=get_root_logger(), device=torch.device("cpu"),
                           comm_info={}, epoch=0, best_metric_value=-np.inf, optimizer=optimizer,
                           scheduler=torch.optim.lr_scheduler.LambdaLR(optimizer, lambda s: 1.0))


def test_probe_loads_a_port_sonata_checkpoint(tmp_path):
    """The probe config's `CheckpointLoader` (``student.backbone.`` ->
    ``backbone.``) on a Sonata checkpoint that the port's `CheckpointSaver`
    wrote: the missing keys are the seg head's alone, the teacher, the SSL
    heads and the mask token are unexpected, and the backbone equals the
    student's bit for bit."""
    sonata = build_model(SONATA, device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in sonata.student.parameters():
            p.add_(0.01)  # the student apart from the teacher and from a fresh model
    saver = CheckpointSaver()
    saver.trainer = _fake_trainer(sonata, tmp_path)
    saver.after_epoch()
    weight = str(tmp_path / "model" / "model_last.pth")
    probe = build_model(_probe_cfg(0, freeze=True), device="cpu", generator=torch.Generator().manual_seed(2))
    loader = CheckpointLoader(keywords="student.backbone.", replacement="backbone.")
    loader.trainer = _fake_trainer(probe, tmp_path, weight)
    loader.before_train()
    info = loader.trainer.comm_info["load_info"]
    assert sorted(info["missing"]) == ["seg_head.bias", "seg_head.weight"]
    unexpected = set(info["unexpected"])
    assert "backbone.embedding.mask_token" in unexpected
    assert any(k.startswith("teacher.backbone.") for k in unexpected)
    assert any(k.startswith("student.mask_head.") for k in unexpected)
    assert all(k.startswith(("teacher.", "student.mask_head.", "student.unmask_head.")) or
               k == "backbone.embedding.mask_token" for k in unexpected)
    student = {k: v for k, v in sonata.student.state_dict().items() if k.startswith("backbone.")}
    own = probe.state_dict()
    assert student.keys() - own.keys() == {"backbone.embedding.mask_token"}
    for key, value in student.items():
        if key in own:
            assert torch.equal(own[key], value), key


def test_checkpoint_shape_mismatch_names_the_tensor(tmp_path):
    probe = build_model(_probe_cfg(0), device="cpu")
    sd = probe.state_dict()
    sd["backbone.enc.enc1.block0.attn.qkv.weight"] = torch.zeros(3, 3)
    torch.save(dict(state_dict=sd), tmp_path / "w.pth")
    loader = CheckpointLoader()
    loader.trainer = _fake_trainer(probe, tmp_path, str(tmp_path / "w.pth"))
    with pytest.raises(RuntimeError, match=r"size mismatch for backbone\.enc\.enc1\.block0\.attn\.qkv\.weight"):
        loader.before_train()


# ------------------------------------------------------------ data


def _write_scenes(root, names, n=4000):
    for i, name in enumerate(names):
        d = root / "train" / name
        d.mkdir(parents=True)
        data = synthesize_scene(i, num_points=n, num_classes=20, extent=3.0)
        np.save(d / "coord.npy", data["coord"].astype(np.float32))
        np.save(d / "color.npy", data["color"].astype(np.float32))
        np.save(d / "normal.npy", data["normal"].astype(np.float32))
        np.save(d / "segment20.npy", data["segment"].astype(np.int64))
    return names


def _dataset_cfg(root, transform=(), **extra):
    return dict(type="ScanNetDataset", split="train", data_root=str(root), transform=list(transform), **extra)


def _la_file(path, names, n=4000, k=40):
    rng = np.random.RandomState(4)
    la = {name: np.sort(rng.choice(n, k, replace=False)) for name in names}
    with open(path, "wb") as f:
        np.save(f, la)  # a pickled dict in an .npy, as the JAX package reads it
    return la


TRAIN_AUG = [dict(type="RandomDropout", dropout_ratio=0.2, dropout_application_ratio=1.0),
             dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train", return_grid_coord=True)]


def test_la_and_lr_datasets_equal_jax(tmp_path):
    """`la_file` (every unlabelled point's label ignored, the labelled
    indices kept as ``sampled_index``) and `lr_file` (the listed train
    scenes), then RandomDropout and GridSample keeping the labelled points:
    the JAX package's arrays bit for bit on the same seeds."""
    names = _write_scenes(tmp_path, ["scene0000_00", "scene0001_00", "scene0002_00"])
    la = _la_file(tmp_path / "points20", names)
    (tmp_path / "lr.txt").write_text("scene0002_00\nscene0000_00\n")
    for extra, transform in ((dict(la_file=str(tmp_path / "points20")), []),
                             (dict(la_file=str(tmp_path / "points20")), TRAIN_AUG),
                             (dict(lr_file=str(tmp_path / "lr.txt")), TRAIN_AUG)):
        cfg = _dataset_cfg(tmp_path, transform, **extra)
        port, ref = build_dataset(copy.deepcopy(cfg)), jax_build_dataset(copy.deepcopy(cfg))
        assert len(port) == len(ref) == (2 if "lr_file" in extra else 3)
        for idx in range(len(ref)):
            outs = []
            for ds in (port, ref):
                np.random.seed(idx)
                random.seed(idx)
                outs.append(ds[idx])
            got, want = outs
            assert got["name"] == want["name"]
            for key in ("coord", "color", "normal", "segment", "grid_coord", "sampled_index"):
                if key in want:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
                else:
                    assert key not in got
            if "la_file" in extra:
                labelled = np.flatnonzero(got["segment"] != -1)
                if transform:
                    # every labelled point survived the dropout and the sampling
                    assert len(got["sampled_index"]) == len(la[got["name"]])
                    assert set(labelled) <= set(got["sampled_index"])
                else:
                    np.testing.assert_array_equal(got["sampled_index"], la[got["name"]])
                    assert set(labelled) <= set(la[got["name"]])
    assert [os.path.basename(p) for p in port.data_list] == ["scene0002_00", "scene0000_00"]


def test_la_file_in_the_reference_format(tmp_path):
    """The reference's `torch.save` of the dict reads as the `np.save` one."""
    names = _write_scenes(tmp_path, ["scene0000_00"])
    la = _la_file(tmp_path / "np", names)
    torch.save({k: torch.as_tensor(v) for k, v in la.items()}, tmp_path / "pt")
    a = build_dataset(_dataset_cfg(tmp_path, la_file=str(tmp_path / "np")))[0]
    b = build_dataset(_dataset_cfg(tmp_path, la_file=str(tmp_path / "pt")))[0]
    np.testing.assert_array_equal(a["sampled_index"], b["sampled_index"])
    np.testing.assert_array_equal(a["segment"], b["segment"])


def test_one_line_lr_file(tmp_path):
    """Fault 6: a one-line `lr_file` (the 1-scene benchmark) reads as a 0-d
    array in the JAX package, which cannot list it; the port lists it."""
    _write_scenes(tmp_path, ["scene0000_00", "scene0001_00"])
    (tmp_path / "1.txt").write_text("scene0001_00\n")
    cfg = _dataset_cfg(tmp_path, lr_file=str(tmp_path / "1.txt"))
    with pytest.raises(TypeError):
        jax_build_dataset(copy.deepcopy(cfg))
    port = build_dataset(copy.deepcopy(cfg))
    assert len(port) == 1 and port[0]["name"] == "scene0001_00"


@pytest.mark.parametrize("cfg", TRAIN_AUG + [dict(type="RandomDropout", dropout_ratio=0.5,
                                                   dropout_application_ratio=1.0)],
                         ids=["dropout", "grid_sample", "dropout_half"])
def test_sampled_index_transforms_equal_jax(cfg):
    data = synthesize_scene(3, num_points=3000, num_classes=20, extent=3.0)
    data["sampled_index"] = np.sort(np.random.RandomState(1).choice(3000, 100, replace=False))
    outs = []
    for registry in (TRANSFORMS, JAX_TRANSFORMS):
        np.random.seed(7)
        random.seed(7)
        outs.append(registry.build(dict(cfg))(copy.deepcopy(data)))
    got, want = outs
    for key in ("coord", "segment", "sampled_index"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the kept points are the labelled ones, at their new positions
    np.testing.assert_array_equal(got["coord"][got["sampled_index"]], data["coord"][data["sampled_index"]])


# ------------------------------------------------------------ tester


def _tester_cfg(save_path, **extra):
    """The probe (one view, capacity 4,096) on two 2,500-point synthetic
    scenes; the test section of tests/test_torch_port_tester.py."""
    model = _probe_cfg(0, freeze=True)
    model["backbone"].update(order=("z", "z-trans"), serialize_depth=10, pool_capacity_factors=(0.7, 0.7),
                             enc_patch_size=(64,) * 3)
    test = dict(
        type="SyntheticSemSegDataset", split="val", num_scenes=2, num_points=2500, num_classes=13,
        transform=[dict(type="CenterShift", apply_z=True), dict(type="NormalizeColor")], test_mode=True,
        test_cfg=dict(
            voxelize=dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="test", return_grid_coord=True),
            crop=None,
            post_transform=[dict(type="CenterShift", apply_z=False), dict(type="ToTensor"),
                            dict(type="Collect", keys=("coord", "grid_coord", "index"),
                                 feat_keys=("color", "normal"))],
            aug_transform=[[dict(type="RandomRotateTargetAngle", angle=[0], axis="z", center=[0, 0, 0], p=1)]],
        ),
    )
    cfg = dict(save_path=str(save_path), batch_size_test_per_gpu=1, point_capacity_test=4096, num_worker=0,
               seed=0, host_geometry=False, model=model,
               data=dict(num_classes=13, ignore_index=-1, names=[f"c{i}" for i in range(13)], test=test))
    cfg.update(extra)
    return cfg


def _preds(save_path):
    rd = os.path.join(str(save_path), "result")
    return {f: np.load(os.path.join(rd, f)) for f in sorted(os.listdir(rd)) if f.endswith("_pred.npy")}


def test_probe_tester_equals_jax_per_fragment_tester(tmp_path):
    """The port's tester on an enc_mode probe takes its per-fragment path
    by itself; the JAX tester is run with ``fragment_geometry_reuse=False``
    (fault 3). Summed preds < 1e-2 relative, argmax > 0.99 (the bounds of
    tests/test_torch_port_tester.py), mIoU within 0.02; the preds' mass is
    the fragment points (each softmax sums to 1)."""
    (tmp_path / "jax").mkdir()
    jt = JAX_TESTERS.build(dict(type="SemSegTester",
                                cfg=JaxConfig(_tester_cfg(tmp_path / "jax", fragment_geometry_reuse=False))))
    want_result = jt.test()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    weights = params_from_jax(tree(jt.state.params), tree(jt.state.batch_stats))
    tester = TESTERS.build(dict(type="SemSegTester", cfg=Config(_tester_cfg(tmp_path / "port")), device="cpu"))
    assert not tester._fragment_geometry_ok()
    tester.model.load_state_dict(weights, strict=True)
    result = tester.test()
    got, want = _preds(tmp_path / "port"), _preds(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 2
    for name, w in want.items():
        g = got[name]
        err, agree = _rel(g, w), (g.argmax(1) == w.argmax(1)).mean()
        assert np.isfinite(g).all() and err < 1e-2 and agree > 0.99, (name, err, agree)
    assert abs(result["mIoU"] - want_result["mIoU"]) < 0.02
    for s, name in zip(tester.scene_stats, sorted(got)):
        assert s["groups"] is None and s["forwards"] == s["fragments"] and s["dropped"] == 0
        np.testing.assert_allclose(got[name].sum(), s["points"], rtol=1e-5)


def test_jax_grouped_tester_fails_on_enc_mode(tmp_path):
    """Fault 3: the JAX tester's gate sends every PT-v3 backbone to the
    shared-geometry path, and the `build_geometry` that path calls refuses
    ``enc_mode``. (The tester's own `test()` is not run here: it raises
    while its prefetch thread is still preparing the next scene.)"""
    cfg = _tester_cfg(tmp_path)
    jt = JAX_TESTERS.build(dict(type="SemSegTester", cfg=JaxConfig(cfg)))
    assert jt._fragment_geometry_ok()
    backbone = jax_build_model(dict(cfg["model"]["backbone"]))
    arrays = {k: jnp.asarray(v) for k, v in _labelled_scene().items()}
    with pytest.raises(AssertionError, match="in-graph eval path only"):
        backbone.build_geometry(jax_point_batch(arrays, 1).replace(feat=None))
