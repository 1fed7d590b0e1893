"""LitePT-v1 in the port against the JAX package, on the CPU.

PointROPE at head dim 18; a 3-stage LitePT (two conv stages, then an
attention stage at head dim 18, patch 32, a decoder with blocks) under
`DefaultSegmentorV2` through `params_from_jax`: eval logits, the
``enc_mode`` skip chain, one train step; the two faults that keep the
eight LitePT configs from running in the JAX package, each named by a
test; and the port's refusal of those configs, naming both. The JAX side
computes LitePT's attention densely (no Pallas); the port's runs on the
patch-attention kernels' plain versions here.

Small model: widths 18, 36, 36 on the 13k-point surface scene of
`tests/test_reference_oracle.py`, the gather engine (LitePT's only)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_torch_port_probe import _cos, _labelled_scene, _rel  # noqa: E402

from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.ops.pointrope import point_rope as jax_point_rope  # noqa: E402
from pointcept_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_tpu_torch.engines import make_point_batch  # noqa: E402
from pointcept_tpu_torch.models import MODELS, apply_amp_policy, build_model  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.ops.pointrope import point_rope  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
LITEPT_CONFIGS = sorted(str(p.relative_to(ROOT / "configs")) for p in (ROOT / "configs").glob("*/*litept*.py"))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a test process (tests/test_torch_port_ptv3.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_point_rope_d18_matches_jax():
    """PointROPE at LitePT's head dim 18 on integer grid positions (as its
    attention reads them) at frequency 100: f32 to 1e-5."""
    rng = np.random.RandomState(18)
    tokens = rng.randn(2, 3, 64, 18).astype(np.float32)
    pos = rng.randint(0, 200, (2, 64, 3)).astype(np.int32)
    want = np.asarray(jax_point_rope(jnp.asarray(tokens), jnp.asarray(pos), freq=100.0))
    got = point_rope(torch.as_tensor(tokens), torch.as_tensor(pos), freq=100.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _backbone(**extra):
    bb = dict(type="LitePT-v1", in_channels=6, stride=(2, 2), enc_depths=(1, 1, 2), enc_channels=(18, 36, 36),
              enc_num_head=(1, 2, 2), enc_patch_size=(32,) * 3, enc_conv=(True, True, False),
              enc_attn=(False, False, True), enc_rope_freq=(100.0,) * 3, dec_depths=(1, 1),
              dec_channels=(18, 36), dec_num_head=(1, 2), dec_patch_size=(32, 32), dec_conv=(True, False),
              dec_attn=(False, False), dec_rope_freq=(100.0,) * 2, mlp_ratio=2, drop_path=0.0,
              shuffle_orders=False, serialize_depth=7, pool_capacity_factors=(0.5, 0.5))
    bb.update(extra)
    return bb


def _cfg():
    return dict(type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=18, backbone=_backbone(),
                criteria=CRITERIA)


@pytest.fixture(scope="module")
def ref():
    """JAX weights of the small LitePT (random, seed 0; perturbed running
    statistics), its eval logits, its encoder's skip chain, and one train
    step's loss and gradients."""
    arrays = _labelled_scene()
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    model = jax_build_model(_cfg())
    variables = jax.jit(lambda r: model.init(r, pb, train=False))({"params": jax.random.PRNGKey(0)})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rs = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5,
                                   variables["batch_stats"])
    res = jax.jit(lambda p, b: model.apply({"params": p, "batch_stats": b}, pb, train=False))(params, stats)
    enc = jax_build_model(_backbone(enc_mode=True))
    enc_vars = {"params": params["backbone_module"], "batch_stats": stats["backbone_module"]}
    out, skips = jax.jit(lambda v: enc.apply(v, pb, train=False))(enc_vars)
    chain = [np.asarray(out.feat)] + [np.asarray(s[0].feat) for s in skips]

    def loss_fn(p):
        o, _ = model.apply({"params": p, "batch_stats": stats}, pb, train=True,
                           rngs={"shuffle": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                           mutable=["batch_stats", "diagnostics"])
        return o["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(arrays=arrays, params=params, stats=stats, logits=np.asarray(res["seg_logits"], np.float32),
                chain=chain, loss=float(loss), grads=jax.tree_util.tree_map(np.asarray, grads))


def _port(ref, cfg=None):
    model = build_model(cfg or _cfg(), device="cpu")
    model.load_state_dict(params_from_jax(ref["params"], ref["stats"]), strict=True)
    return model


def test_litept_logits_match_jax(ref):
    """Eval logits, f32 stream with bf16 conv and attention operands:
    < 1e-2 relative, argmax > 0.99 (`PERF.md` §2). The state dict names
    LitePT's pieces after the JAX package (norm0, conv, norm1, attn, norm2,
    mlp) and its shared ones as PT-v3's."""
    model = _port(ref)
    sd = model.state_dict()
    for name in ("backbone.embedding.stem.conv.weight", "backbone.enc.enc0.block0.norm0.weight",
                 "backbone.enc.enc0.block0.conv.bias", "backbone.enc.enc2.block1.attn.qkv.weight",
                 "backbone.enc.enc2.block0.norm1.bias", "backbone.enc.enc1.down.norm.0.running_var",
                 "backbone.dec.dec0.block0.conv.weight", "backbone.dec.dec1.up.proj_skip.0.weight",
                 "backbone.dec.dec1.block0.mlp.fc2.bias"):
        assert name in sd, name
    assert "backbone.enc.enc2.block0.conv.weight" not in sd  # the attention stage has no conv
    out = model(make_point_batch(ref["arrays"], 1, device="cpu"))
    v = ref["arrays"]["batch"] >= 0
    g, w = out["seg_logits"].numpy()[v], ref["logits"][v]
    err, agree = _rel(g, w), (g.argmax(1) == w.argmax(1)).mean()
    assert np.isfinite(g).all() and err < 1e-2 and agree > 0.99, (err, agree)
    assert [int(x) for x in out["diagnostics"]["pool_overflow"]] == [0, 0]


def test_litept_enc_mode_skips_match_jax(ref):
    """``enc_mode``: the last stage's features and each skip's (the stem's,
    stage 1's) against the JAX encoder's, within 1e-2 of each one's largest
    value."""
    model = build_model(_backbone(enc_mode=True), device="cpu")
    sd = {k[len("backbone."):]: v for k, v in params_from_jax(ref["params"], ref["stats"]).items()
          if k.startswith(("backbone.enc.", "backbone.embedding."))}
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out, diag, skips = model(make_point_batch(ref["arrays"], 1, device="cpu"))
    got = [out.feat.numpy()] + [s[0].feat.numpy() for s in skips]
    assert len(got) == len(ref["chain"]) == 3
    for g, w in zip(got, ref["chain"]):
        assert g.shape == w.shape and _rel(g, w) < 1e-2, (g.shape, _rel(g, w))


def test_litept_train_step_matches_jax(ref):
    """One train step (CE + Lovász, drop path 0, unshuffled): the loss
    within 2e-2, every gradient within 5e-2 relative L2 with cosine above
    0.999 (`PERF.md` §2); tensors whose gradient vanishes in exact
    arithmetic (biases before train-mode BatchNorms) are held to the noise
    floor instead."""
    model = _port(ref).train()
    res = model(make_point_batch(ref["arrays"], 1, device="cpu"), generator=torch.Generator().manual_seed(0))
    res["loss"].backward()
    loss = float(res["loss"].detach())
    assert abs(loss - ref["loss"]) / ref["loss"] < 2e-2, (loss, ref["loss"])
    jgrads = {n: g.numpy() for n, g in params_from_jax(ref["grads"], {}).items()}
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    assert set(grads) == set(jgrads)
    gmax = max(np.abs(g).max() for g in grads.values())
    bad = {}
    for name, g in grads.items():
        w = jgrads[name]
        if np.abs(g).max() < 1e-6 * gmax:
            if max(np.abs(g).max(), np.abs(w).max()) > 1e-3 * gmax:
                bad[name] = "vanishing gradient above the noise floor"
            continue
        err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        if not (err < 5e-2 and _cos(g, w) > 0.999):
            bad[name] = (err, _cos(g, w))
    assert not bad, bad


# ------------------------------------------------------------ the configs


def test_jax_litept_configs_name_patch_size():
    """JAX-side fault: every LitePT config names ``patch_size=1024``, which
    `LitePT-v1` does not take; building its backbone raises `TypeError`
    (under `DefaultSegmentorV2` only at init, which builds it lazily)."""
    cfg = JaxConfig.fromfile(str(ROOT / "configs/scannet/semseg-litept-v1m1-0-small.py"))
    assert cfg.model.backbone.patch_size == 1024
    with pytest.raises(TypeError, match="patch_size"):
        jax_build_model(dict(cfg.model.backbone))


def test_jax_litept_config_head_dim_16_fails_rope():
    """JAX-side fault: without ``patch_size``, the config's attention stages
    (256 / 16, 512 / 32: head dim 16) fail PointROPE's multiple-of-3
    assertion at init."""
    cfg = JaxConfig.fromfile(str(ROOT / "configs/scannet/semseg-litept-v1m1-0-small.py"))
    bb = {k: v for k, v in dict(cfg.model.backbone).items() if k != "patch_size"}
    model = jax_build_model(bb)
    rng = np.random.RandomState(0)
    grid = np.unique(rng.randint(0, 24, (600, 3)), axis=0).astype(np.int32)
    n, cap = len(grid), 1024
    arrays = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                  grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32))
    arrays["coord"][:n], arrays["grid_coord"][:n], arrays["batch"][:n] = grid * 0.02, grid, 0
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    with pytest.raises(AssertionError, match="multiple of 3 for PointROPE"):
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), pb, train=False))


@pytest.mark.parametrize("path", LITEPT_CONFIGS)
def test_port_refuses_litept_configs_with_both_faults(path):
    """The port refuses each of the eight LitePT configs at build, with a
    message that names both faults (`patch_size`, and the attention stages'
    head dims that are not multiples of 6); the class defaults build."""
    assert len(LITEPT_CONFIGS) == 8
    cfg = Config.fromfile(str(ROOT / "configs" / path))
    with torch.device("meta"), pytest.raises(TypeError, match=r"patch_size.*head dims .* = 16\b.* multiples of 6"):
        MODELS.build(apply_amp_policy(dict(cfg.model), cfg.enable_amp))


def test_class_defaults_build_and_refuse_other_options():
    """`LitePT-v1` at the class defaults (head dim 18 everywhere, the
    configs' input width and depth): 72 output channels; no `amp` for
    `apply_amp_policy` to set; a head dim that is not a multiple of 6
    raises at build, naming the stage; dropout raises."""
    with torch.device("meta"):
        model = MODELS.build(dict(type="LitePT-v1", in_channels=6, serialize_depth=11))
    assert model.out_channels == 72
    cfg = apply_amp_policy(dict(backbone=dict(type="LitePT-v1")), True)
    assert "amp" not in cfg["backbone"]
    with pytest.raises(ValueError, match=r"enc3: 256/16 = 16"):
        MODELS.build(dict(type="LitePT-v1", enc_channels=(36, 72, 144, 256, 504), enc_num_head=(2, 4, 8, 16, 28)))
    for option in (dict(attn_drop=0.1), dict(proj_drop=0.1)):
        with pytest.raises(NotImplementedError):
            MODELS.build(dict(type="LitePT-v1", **option))
