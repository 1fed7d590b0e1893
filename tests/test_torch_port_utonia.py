"""Utonia's backbone in the port against the JAX package, on the CPU.

3D RoPE (`ops/pointrope.py`), PT-v3m3 (PT-v3m2 with RoPE on q and k, at
Utonia's head dim 18) under `DefaultSegmentorV2` in ``enc_mode`` (the
linear probe and fine-tune configs): its logits and one train step; the
train-time augmentations of the RoPE positions by their ranges; the
tester's grouped path on a RoPE decoder config, which must bring each
fragment's own coordinates; the plain attention at head dim 18 against
the JAX kernels; the zero padding of head dim 18 onto the D = 24 kernels;
and fault 5, a config width that differs from the data.

Small model: 3 stages of widths 18, 36, 72 (head dim 18, Utonia's), patch
128, the gather engine, one block a stage, on the 13k-point surface scene
of `tests/test_reference_oracle.py`."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_torch_port_probe import _cos, _labelled_scene, _preds, _rel, _tester_cfg  # noqa: E402

from pointcept_tpu.engines.test import TESTERS as JAX_TESTERS  # noqa: E402
from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.ops.pointrope import point_rope as jax_point_rope  # noqa: E402
from pointcept_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_tpu_torch.engines import TESTERS, make_point_batch  # noqa: E402
from pointcept_tpu_torch.models import build_model  # noqa: E402
from pointcept_tpu_torch.models.point_transformer_v3.point_transformer_v3 import SerializedAttention  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.ops import kernels  # noqa: E402
from pointcept_tpu_torch.ops.pointrope import point_rope  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENC = (18, 36, 72)
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _backbone(**extra):
    bb = dict(type="PT-v3m3", in_channels=6, order=("z", "z-trans", "hilbert", "hilbert-trans"),
              stride=(2, 2), enc_depths=(1, 1, 1), enc_channels=ENC, enc_num_head=(1, 2, 4),
              enc_patch_size=(128,) * 3, mlp_ratio=2, drop_path=0.0, shuffle_orders=False,
              serialize_depth=7, pool_capacity_factors=(0.5, 0.5), conv_engine="gather", enc_mode=True,
              mask_token=True, rope_base=10.0)
    bb.update(extra)
    return bb


def _cfg(**extra):
    return dict(type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=sum(ENC),
                backbone=_backbone(**extra), up_cast_level=0, criteria=CRITERIA)


# ------------------------------------------------------------ RoPE


@pytest.mark.parametrize("d,dtype", [(18, np.float32), (6, np.float32), (18, "bfloat16")])
def test_point_rope_matches_jax(d, dtype):
    """Rotated tokens [nP, H, K, D] by float positions [nP, K, 3]: f32 to
    1e-5 (sin and cos of the two libraries), bf16 to one bf16 ulp of the
    largest value (both round cos and sin to bf16 before they multiply)."""
    rng = np.random.RandomState(d)
    tokens = rng.randn(2, 3, 64, d).astype(np.float32)
    pos = (rng.rand(2, 64, 3) * 6.0).astype(np.float32)
    jt = jnp.asarray(tokens, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jax_point_rope(jt, jnp.asarray(pos), freq=10.0), np.float32)
    tt = torch.as_tensor(tokens).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = point_rope(tt, torch.as_tensor(pos), freq=10.0).float().numpy()
    tol = 2 ** -7 * np.abs(want).max() if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    with pytest.raises(ValueError, match="multiple of 6"):
        point_rope(torch.zeros(1, 1, 4, 16), torch.zeros(1, 4, 3))


# ------------------------------------------------------------ PT-v3m3


@pytest.fixture(scope="module")
def ref():
    """JAX weights of the small Utonia probe (random, seed 0; perturbed
    running statistics), its eval logits, and one train step's loss,
    gradients and running statistics."""
    arrays = _labelled_scene()
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    model = jax_build_model(_cfg())
    variables = jax.jit(lambda r: model.init(r, pb, train=False))({"params": jax.random.PRNGKey(0)})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rs = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5,
                                   variables["batch_stats"])
    res = jax.jit(lambda p, b: model.apply({"params": p, "batch_stats": b}, pb, train=False))(params, stats)

    def loss_fn(p):
        out, upd = model.apply({"params": p, "batch_stats": stats}, pb, train=True,
                               rngs={"shuffle": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                               mutable=["batch_stats", "diagnostics"])
        return out["loss"], upd["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(arrays=arrays, params=params, stats=stats, logits=np.asarray(res["seg_logits"], np.float32),
                loss=float(loss), grads=tree(grads), new_stats=tree(new_stats))


def _port(ref):
    model = build_model(_cfg(), device="cpu")
    model.load_state_dict(params_from_jax(ref["params"], ref["stats"]), strict=True)
    return model


def test_utonia_probe_logits_match_jax(ref):
    """Eval logits of PT-v3m3 (RoPE at base 10, head dim 18, the mask
    token) under the up-cast: f32 stream, bf16 attention operands: < 1e-2
    relative, argmax > 0.99 (the bounds of tests/test_torch_port_ptv3.py).
    RoPE moves the logits: without it they differ from JAX's."""
    model = _port(ref)
    assert all(b.attn.rope == dict(base=10.0, shift=None, jitter=None, rescale=None)
               for s in range(3) for b in [getattr(getattr(model.backbone.enc, f"enc{s}"), "block0")])
    pb = make_point_batch(ref["arrays"], 1, device="cpu")
    got = model(pb)["seg_logits"].numpy()
    v = ref["arrays"]["batch"] >= 0
    g, w = got[v], ref["logits"][v]
    err, agree = _rel(g, w), (g.argmax(1) == w.argmax(1)).mean()
    assert np.isfinite(g).all() and err < 1e-2 and agree > 0.99, (err, agree)
    for s in range(3):
        getattr(model.backbone.enc, f"enc{s}").block0.attn.rope = None
    assert _rel(model(pb)["seg_logits"].numpy()[v], w) > 2 * err


def test_utonia_train_step_matches_jax(ref):
    """One fine-tune step (CE + Lovász, drop path 0, unshuffled, no
    coordinate augmentation): the loss within 2e-2 and every gradient
    within 5e-2 relative L2 with cosine above 0.999, the f32 bounds of
    tests/test_torch_port_train.py; tensors whose gradient vanishes in
    exact arithmetic (biases before train-mode BatchNorms, the unused mask
    token) are held to the noise floor instead. The running statistics
    within rtol 1e-3."""
    model = _port(ref)
    model.train()
    res = model(make_point_batch(ref["arrays"], 1, device="cpu"), generator=torch.Generator().manual_seed(0))
    res["loss"].backward()
    loss = float(res["loss"].detach())
    assert abs(loss - ref["loss"]) / ref["loss"] < 2e-2, (loss, ref["loss"])
    jgrads = {n: g.numpy() for n, g in params_from_jax(ref["grads"], {}).items()}
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    assert set(grads) == set(jgrads) - {"backbone.embedding.mask_token"}
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
    assert not np.abs(jgrads["backbone.embedding.mask_token"]).any()
    want = params_from_jax({}, ref["new_stats"])
    sd = model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(sd[name].numpy(), value.numpy(), rtol=1e-3, atol=1e-5, err_msg=name)


def test_rope_augmentations_by_their_ranges():
    """Train mode with a generator: one shift in (-s, s) per axis, one
    jitter factor in (1/j, j) per axis, one rescale factor in (1/r, r),
    each shared by every point; eval mode, or none set, leaves the
    coordinates; the same seed draws the same positions."""
    coord = torch.as_tensor(np.random.RandomState(0).rand(500, 3).astype(np.float32) * 4 + 0.5)
    cases = [(dict(shift=0.5), "shift"), (dict(jitter=1.2), "jitter"), (dict(rescale=1.5), "rescale")]
    for rope, kind in cases:
        attn = SerializedAttention(18, 1, 128, rope=dict(base=10.0, **rope)).train()
        for seed in range(20):
            pos = attn.rope_positions(coord, torch.Generator().manual_seed(seed))
            if kind == "shift":
                d = pos - coord
                assert torch.allclose(d, d[:1].expand_as(d), atol=1e-6) and bool((d.abs() < 0.5).all())
            else:
                f = pos / coord
                assert torch.allclose(f, f[:1].expand_as(f), rtol=1e-5)
                bound = rope[kind]
                assert bool((f > 1 / bound).all() and (f < bound).all())
                if kind == "rescale":
                    assert torch.allclose(f[0], f[0, :1].expand(3), rtol=1e-6)
            again = attn.rope_positions(coord, torch.Generator().manual_seed(seed))
            assert torch.equal(pos, again)
        with pytest.raises(ValueError, match="explicit generator"):
            attn.rope_positions(coord, None)
        assert attn.eval().rope_positions(coord, None) is coord
    off = SerializedAttention(18, 1, 128, rope=dict(base=10.0, shift=None, jitter=1.0, rescale=None)).train()
    assert off.rope_positions(coord, None) is coord


def test_config_width_differing_from_the_data_raises():
    """Fault 5: Utonia's probe config sets ``in_channels=9`` while its data
    section (ScanNet's base config) collects 6 channels (color, normal); the
    JAX stem infers 6, the port's Linear stem cannot, and raises with both
    numbers."""
    cfg = Config.fromfile(str(ROOT / "configs/utonia/semseg-utonia-v1m1-0a-scannet-lin.py"))
    assert cfg.model.backbone.in_channels == 9
    collect = [t for t in cfg.data.train.transform if t["type"] == "Collect"][0]
    assert tuple(collect["feat_keys"]) == ("color", "normal")
    model = build_model(_cfg(in_channels=9), device="cpu")
    arrays = _labelled_scene()
    with pytest.raises(ValueError, match=r"in_channels=9 .* 6 channels"):
        model(make_point_batch(arrays, 1, device="cpu"))


def test_rope_needs_head_dims_of_multiples_of_6():
    with pytest.raises(ValueError, match="multiples of 6"):
        build_model(_cfg(enc_channels=(16, 32, 64), enc_num_head=(1, 2, 4)), device="cpu")
    m1 = build_model(dict(_backbone(type="PT-v3m1", rope_base=None, mask_token=False)), device="cpu")
    assert m1.rope is None


# ------------------------------------------------------------ tester


def _rope_tester_cfg(save_path, **extra):
    """A RoPE decoder config (PT-v3m3 with its decoder, rope base 10) in the
    test section of `_tester_cfg`: the grouped path."""
    cfg = _tester_cfg(save_path, **extra)
    cfg["model"] = dict(
        type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=18,
        backbone=_backbone(enc_mode=False, order=("z", "z-trans"), serialize_depth=10, enc_depths=(1, 1),
                           enc_channels=(18, 36), enc_num_head=(1, 2), enc_patch_size=(64, 64), stride=(2,),
                           pool_capacity_factors=(0.7,), dec_depths=(1,), dec_channels=(18,), dec_num_head=(1,),
                           dec_patch_size=(64,)),
        criteria=CRITERIA[:1])
    return cfg


def test_rope_grouped_tester_equals_jax(tmp_path):
    """The grouped path (one geometry a voxel grid) on a RoPE decoder
    config reads each fragment's own coordinates: against the JAX grouped
    tester (which sends coords on its wire for RoPE) < 1e-2 relative and
    argmax > 0.99, mIoU within 0.02; against the port's per-fragment path
    to f32 summation order (1e-4)."""
    (tmp_path / "jax").mkdir()
    jt = JAX_TESTERS.build(dict(type="SemSegTester", cfg=JaxConfig(_rope_tester_cfg(tmp_path / "jax"))))
    assert jt._fragment_geometry_ok() and not jt._coord_from_grid_ok()
    want_result = jt.test()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    weights = params_from_jax(tree(jt.state.params), tree(jt.state.batch_stats))
    results = {}
    for path, extra in (("grouped", {}), ("single", dict(fragment_geometry_reuse=False))):
        tester = TESTERS.build(dict(type="SemSegTester", cfg=Config(_rope_tester_cfg(tmp_path / path, **extra)),
                                    device="cpu"))
        assert tester._fragment_geometry_ok() == (path == "grouped") and tester._fragment_coord()
        tester.model.load_state_dict(weights, strict=True)
        results[path] = (tester.test(), _preds(tmp_path / path), tester.scene_stats)
    want = _preds(tmp_path / "jax")
    result, got, stats = results["grouped"]
    assert got.keys() == want.keys() and len(got) == 2
    assert all(s["groups"] == 1 and s["fragments"] > 1 for s in stats)
    for name, w in want.items():
        g = got[name]
        err, agree = _rel(g, w), (g.argmax(1) == w.argmax(1)).mean()
        assert np.isfinite(g).all() and err < 1e-2 and agree > 0.99, (name, err, agree)
        np.testing.assert_allclose(g, results["single"][1][name], rtol=1e-4, atol=1e-4)
    assert abs(result["mIoU"] - want_result["mIoU"]) < 0.02


# ------------------------------------------------------------ attention at head dim 18


def _bf16(a):
    t = torch.as_tensor(a).to(torch.bfloat16)
    return t.float().numpy(), t


@pytest.mark.parametrize("np_,k,c,h", [(3, 128, 54, 3), (1, 1024, 36, 2)])
def test_plain_attention_at_head_dim_18_matches_jax(np_, k, c, h):
    """The plain forward and backward at head dim 18 (scale 18^-0.5)
    against the JAX Pallas kernel (interpret mode) and its `jax.vjp`, on the
    same bf16 qkv and cotangent: the tolerances of
    tests/test_torch_port_kernels.py (2e-2 forward; 2e-2 of the largest
    gradient plus 2e-2 relative backward)."""
    from pointcept_tpu.ops.pallas.flash_attention import flash_patch_attention_kmajor

    rng = np.random.RandomState(k + c)
    d = c // h
    assert d == 18
    scale = d**-0.5
    qkv, tq = _bf16(rng.randn(np_, k, 3 * c).astype(np.float32))
    dout, tdo = _bf16(rng.randn(np_, k, c).astype(np.float32))

    def fwd(x):
        return flash_patch_attention_kmajor(x.reshape(np_, k, 3, h, d), scale=scale).reshape(np_, k, c)

    want_out, vjp = jax.vjp(fwd, jnp.asarray(qkv, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(dout, jnp.bfloat16))
    want, want_out = np.asarray(want, np.float32), np.asarray(want_out, np.float32)
    out, m, l = kernels.patch_attention_fwd(tq, h, scale, stats=True)
    np.testing.assert_allclose(out.float().numpy(), want_out, atol=2e-2, rtol=2e-2)
    got = kernels.patch_attention_bwd(tq, out, tdo, m, l, h, scale).float().numpy()
    assert np.abs(want).max() > 0
    assert (np.abs(got - want) <= 2e-2 * np.abs(want).max() + 2e-2 * np.abs(want)).all(), (
        float(np.abs(got - want).max() / np.abs(want).max()))


def test_head_dim_18_padding_is_exact():
    """Head dim 18 runs the D = 24 kernels on zero-padded heads: the plain
    versions on the padded operands, sliced back, give the D = 18 results
    (forward output and statistics, the backward's gradients) within f32
    summation order, at the same scale 18^-0.5; the padded columns come
    out zero."""
    from pointcept_tpu_torch.ops.kernels.patch_attention import _pad_heads, _unpad_heads

    g = torch.Generator().manual_seed(18)
    np_, k, h = 3, 48, 3
    qkv = torch.randn((np_, k, 3 * 18 * h), generator=g).to(torch.bfloat16)
    dout = torch.randn((np_, k, 18 * h), generator=g).to(torch.bfloat16)
    scale = 18**-0.5
    out, m, l = kernels.patch_attention_fwd_plain(qkv, h, scale, stats=True)
    pout, pm, pl = kernels.patch_attention_fwd_plain(_pad_heads(qkv, h, 3, 24), h, scale, stats=True)
    assert pout.shape == (np_, k, 24 * h)
    assert not pout.reshape(np_, k, h, 24)[..., 18:].float().abs().any()
    torch.testing.assert_close(_unpad_heads(pout, h, 1, 18).float(), out.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(pm, m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pl, l, atol=1e-5, rtol=1e-5)
    want = kernels.patch_attention_bwd_plain(qkv, out, dout, m, l, h, scale)
    got = kernels.patch_attention_bwd_plain(_pad_heads(qkv, h, 3, 24), _pad_heads(out, h, 1, 24),
                                            _pad_heads(dout, h, 1, 24), m, l, h, scale)
    assert not got.reshape(np_, k, 3, h, 24)[..., 18:].float().abs().any()
    torch.testing.assert_close(_unpad_heads(got, h, 3, 18).float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("k", [48, 128, 512, 1008, 1024])
def test_head_dim_24_plans_fit_at_utonia_patch_sizes(k):
    """At D = 24 (head dim 18 padded) both kernels fit in shared memory up
    to K = 1024: the forward's K and V at two blocks an SM (96 KB at K =
    1024, where D = 32's 128 KB allow one), the backward as a cluster of at
    most 8 blocks of 8 warps with two key tiles of 16 each where K is a
    multiple of 32 (200 KB a block at K = 1024, where D = 32 would need 264
    KB) that cover the keys exactly."""
    from pointcept_tpu_torch.ops.kernels.patch_attention import SMEM_LIMIT, bwd_plan, fwd_shared_memory

    assert 2 * fwd_shared_memory(k, 24) <= SMEM_LIMIT
    s, w, t, smem = bwd_plan(k, 24)
    assert smem <= SMEM_LIMIT and 1 <= s <= 8 and 1 <= w <= 8 and t == (2 if k % 32 == 0 else 1), (s, w, t, smem)
    assert (s - 1) * w * 16 * t < k <= s * w * 16 * t
    if k == 1024:
        assert (s, w, smem) == (4, 8, 204800) and bwd_plan(k, 32)[3] > SMEM_LIMIT
