"""SpUNet-v1m1 + DefaultSegmentor of the port against the JAX package on the
CPU: the eval logits (gather engine, block engine, fused block engine), one
train step (cross-entropy, SGD with nesterov momentum, OneCycle), the weight
round trip through `convert_spunet`, the strided maps and convs, the v1m2
momenta and the MinkUNet registrations.

Small model: widths 8-64, one block a stage, a ~4,200-point surface scene,
`block_engine_min_points` 1024, so levels 0-2 take the block engine (8^3
blocks) and levels 3-4 the gather engine. The port's seeded weights go to
JAX through the JAX package's converter. JAX's block engine runs its default
`lax.conv` route: its fused Pallas route is held equal to that one by
tests/test_tap_conv.py, and the port's fused conv against the fused Pallas
route by tests/test_torch_port_tap_conv.py (compiling the whole model's
interpret-mode kernels takes minutes)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_reference_oracle import _surface_scene  # noqa: E402

from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import MODELS as JAX_MODELS  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.models.sparse_unet import spconv_unet as jspunet  # noqa: E402
from pointcept_tpu.models.utils.convert import convert_state_dict  # noqa: E402
from pointcept_tpu.ops import serialization as jser  # noqa: E402
from pointcept_tpu.ops import sparse_conv as jsc  # noqa: E402
from pointcept_tpu.utils.optimizer import build_optimizer as jax_build_optimizer  # noqa: E402
from pointcept_tpu.utils.scheduler import build_scheduler as jax_build_scheduler  # noqa: E402
from pointcept_tpu_torch.engines import build_train_step, make_point_batch  # noqa: E402
from pointcept_tpu_torch.models import MODELS, build_model  # noqa: E402
from pointcept_tpu_torch.models.sparse_unet import spconv_unet as tspunet  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.ops import sparse_conv as tsc  # noqa: E402
from pointcept_tpu_torch.utils import build_optimizer, build_scheduler  # noqa: E402

OPTIMIZER = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=0.0001, nesterov=True)
SCHEDULER = dict(type="OneCycleLR", max_lr=0.05, pct_start=0.05, anneal_strategy="cos",
                 div_factor=10.0, final_div_factor=10000.0)


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


def T(a):
    return torch.as_tensor(np.array(a))


def _cfg(engine, fused=False, jax_side=False):
    backbone = dict(type="SpUNet-v1m1", in_channels=6, num_classes=13, base_channels=8,
                    channels=(8, 16, 32, 64, 64, 32, 24, 24), layers=(1,) * 8, serialize_depth=8,
                    conv_engine=engine, block_engine_min_points=1024)
    if not jax_side:
        backbone["block_conv_fused"] = fused
    return dict(type="DefaultSegmentor", backbone=backbone,
                criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])


def _jax_model(engine):
    return jax_build_model(_cfg(engine, jax_side=True))


@pytest.fixture(scope="module")
def ref():
    """The scene (4,216 points, capacity 4,608; labels 0-11 of 13, a tenth
    ignored), the port's seeded weights with non-trivial running statistics,
    their JAX trees, and JAX's eval logits for both engines."""
    grid, feat = _surface_scene(span=50, seed=3, keep=0.4)
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
    model = build_model(_cfg("block", fused=True), device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(5)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.numpy()
        sd[k] = v + rs.rand(*v.shape).astype(np.float32) * 0.5 if k.endswith(("running_mean", "running_var")) else v
    params, stats, unmatched = convert_state_dict(sd, "SpUNet-v1m1")
    assert unmatched == []
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    logits = {}
    for engine in ("gather", "block"):
        jm = _jax_model(engine)
        out = jax.jit(lambda p, b: jm.apply({"params": p, "batch_stats": b}, pb, train=False))(params, stats)
        logits[engine] = np.asarray(out["seg_logits"], np.float32)
    return dict(arrays=arrays, valid=arrays["batch"] >= 0, sd=sd, params=params, stats=stats, pb=pb,
                logits=logits)


def _port(ref, engine, fused=False):
    model = build_model(_cfg(engine, fused), device="cpu")
    model.load_state_dict(params_from_jax(ref["params"], ref["stats"]), strict=True)
    return model


@pytest.mark.parametrize("engine,fused", [("gather", False), ("block", False), ("block", True)])
def test_logits_match_jax(ref, engine, fused):
    """f32 stream, bf16 conv operands on both sides (measured 2-3e-4 and
    full argmax agreement); the bounds of tests/test_torch_port_ptv3.py."""
    res = _port(ref, engine, fused)(make_point_batch(ref["arrays"], 1, device="cpu"))
    v = ref["valid"]
    got, want = res["seg_logits"].numpy()[v], ref["logits"][engine][v]
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    agree = (got.argmax(1) == want.argmax(1)).mean()
    assert err < 1e-2 and agree > 0.99, (err, agree)
    diag = res["diagnostics"]
    assert len(diag["pool_overflow"]) == 4 and len(diag["block_overflow"]) == (3 if engine == "block" else 0)
    assert sum(int(x) for x in diag["pool_overflow"] + diag["block_overflow"]) == 0
    assert np.isfinite(float(res["loss"])) and not res["loss"].requires_grad


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cos(got, want):
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _jax_sgd(params):
    return jax_build_optimizer(OPTIMIZER, params, jax_build_scheduler(SCHEDULER, total_steps=1000), None)


def _port_grads(ref, arrays):
    model = _port(ref, "block", fused=True)
    model.train()
    model(make_point_batch(arrays, 1, device="cpu"))["loss"].backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def test_train_step_matches_jax(ref):
    """The port's fused block engine against JAX's block engine: loss, every
    gradient, the update (JAX's SGD chain applied to the port's gradients)
    and the running statistics.

    The gradients of this small model are sensitive by nature: its convs
    round their operands to bf16, and its coarse levels hold a few hundred
    points under train-mode BatchNorm, so the port's own step on features
    scaled by 1 + 1e-6 * N(0, 1) moves its gradient tensors by up to 4.6e-1
    relative L2 (measured; port against JAX up to 1.9e-1, each below its
    own floor's double). Each tensor is held to the bounds of
    tests/test_torch_port_train.py in f32, or to twice its own noise floor
    where that is above them, as chip_smoke.py's phase 8 does."""
    jm = _jax_model("block")

    def loss_fn(params):
        out, upd = jm.apply({"params": params, "batch_stats": ref["stats"]}, ref["pb"], train=True,
                            mutable=["batch_stats"])
        return out["loss"], upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(ref["params"])
    model = _port(ref, "block", fused=True)
    optimizer = build_optimizer(OPTIMIZER, model)
    step = build_train_step(model, optimizer, build_scheduler(SCHEDULER, optimizer, total_steps=1000))
    res = step(make_point_batch(ref["arrays"], 1, device="cpu"), torch.Generator().manual_seed(0))
    assert int(res["pool_overflow"]) == 0 and int(res["block_overflow"]) == 0
    assert abs(float(res["loss"]) - float(loss)) < 2e-2 * abs(float(loss)), (float(res["loss"]), float(loss))

    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    want = {n: g.numpy() for n, g in params_from_jax(jax.tree_util.tree_map(np.asarray, grads), {}).items()}
    assert set(got) == set(want)
    arrays = ref["arrays"]
    nudge = 1 + 1e-6 * np.random.RandomState(0).randn(*arrays["feat"].shape).astype(np.float32)
    floor_grads = _port_grads(ref, dict(arrays, feat=arrays["feat"] * nudge))
    bad = {}
    for n, g in got.items():
        floor, floor_cos = _rel_l2(floor_grads[n], g), _cos(floor_grads[n], g)
        err, cos = _rel_l2(g, want[n]), _cos(g, want[n])
        if not (err < max(5e-2, 2 * floor) and cos > min(0.999, 1 - 2 * (1 - floor_cos))):
            bad[n] = (err, cos, floor, floor_cos)
    assert not bad, bad
    # the head sees no bf16 rounding after its input: tight on both counts
    assert _rel_l2(got["backbone.final.weight"], want["backbone.final.weight"]) < 1e-2

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    port_grads, _, unmatched = convert_state_dict(got, "SpUNet-v1m1")
    assert unmatched == []
    tx = _jax_sgd(ref["params"])
    updates, _ = tx.update(port_grads, tx.init(ref["params"]), ref["params"])
    want_sd = params_from_jax(optax.apply_updates(ref["params"], updates), stats)
    before = params_from_jax(ref["params"], {})
    for name, _ in model.named_parameters():
        np.testing.assert_allclose(sd[name], want_sd[name].numpy(), rtol=1e-6, atol=1e-8, err_msg=name)
        assert not np.array_equal(sd[name], before[name].numpy()), name
    for name in sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name], want_sd[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)


def test_state_dict_round_trips_through_jax_converter(ref):
    """The port's reference names through `convert_spunet` and back."""
    sd = ref["sd"]
    for name in ("backbone.conv_input.0.weight", "backbone.conv_input.1.running_var",
                 "backbone.down.0.0.weight", "backbone.up.3.1.bias", "backbone.enc.1.block0.conv1.weight",
                 "backbone.dec.0.block0.proj.0.weight", "backbone.dec.0.block0.proj.1.weight",
                 "backbone.final.weight", "backbone.final.bias"):
        assert name in sd, name
    back = params_from_jax(ref["params"], ref["stats"])
    assert set(back) == set(sd)
    for name, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[name], err_msg=name)
    jm = _jax_model("gather")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ref["pb"], train=False))
    flat_w = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    flat_g = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    assert all(np.shape(a) == b.shape for (_, a), (_, b) in zip(flat_g, flat_w))


def test_sgd_onecycle_matches_jax():
    """Three SGD (nesterov, weight decay) + OneCycle steps, the same
    gradients fed to both sides."""
    rng = np.random.RandomState(2)
    w0 = {"a": rng.randn(6, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in w0.items()} for _ in range(3)]
    total = 100
    jparams = {"a": {"kernel": jnp.asarray(w0["a"])}, "b": {"bias": jnp.asarray(w0["b"])}}
    tx = jax_build_optimizer(OPTIMIZER, jparams, jax_build_scheduler(SCHEDULER, total_steps=total), None)
    state = tx.init(jparams)
    model = torch.nn.Module()
    model.a = torch.nn.Parameter(T(w0["a"]))
    model.b = torch.nn.Parameter(T(w0["b"]))
    optimizer = build_optimizer(OPTIMIZER, model)
    assert isinstance(optimizer, torch.optim.SGD) and optimizer.param_groups[0]["nesterov"]
    scheduler = build_scheduler(SCHEDULER, optimizer, total_steps=total)
    for g in grads:
        jg = {"a": {"kernel": jnp.asarray(g["a"])}, "b": {"bias": jnp.asarray(g["b"])}}
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        model.a.grad, model.b.grad = T(g["a"]), T(g["b"])
        optimizer.step()
        scheduler.step()
        np.testing.assert_allclose(model.a.detach().numpy(), np.asarray(jparams["a"]["kernel"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(model.b.detach().numpy(), np.asarray(jparams["b"]["bias"]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("capacity", [640, 2304])
def test_strided_maps_and_convs_match_jax(ref, capacity):
    """`build_strided_maps` bit-identical to the JAX package's (a capacity
    that drops clusters, and one that does not); the strided and inverse
    convs on them (f32, the same products in another order)."""
    arrays = ref["arrays"]
    mask = arrays["batch"] >= 0
    kb = np.where(mask, arrays["batch"], int(jser.BATCH_SENTINEL)).astype(np.int32)
    grid = arrays["grid_coord"]
    want = jsc.build_strided_maps(jnp.asarray(grid), jnp.asarray(kb), jnp.asarray(mask), 8, capacity)
    got = tsc.build_strided_maps(T(grid), T(kb), T(mask), 8, capacity)
    for name, w in zip(("out_grid", "out_batch", "child", "parent_of", "child_slot"), want):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w), err_msg=name)
    dropped = int((mask & (np.asarray(want[3]) >= capacity)).sum())
    assert int(got["overflow"]) == dropped and (dropped > 0) == (capacity == 640)
    rng = np.random.RandomState(capacity)
    feat = rng.randn(len(grid), 8).astype(np.float32)
    w = rng.randn(8, 8, 16).astype(np.float32) * 0.3
    out = np.asarray(jsc.strided_conv(jnp.asarray(feat), want[2], jnp.asarray(w)))
    np.testing.assert_allclose(tsc.strided_conv(T(feat), got["child"], T(w)).numpy(), out, rtol=1e-5, atol=1e-5)
    coarse = rng.randn(capacity, 16).astype(np.float32)
    wi = rng.randn(8, 16, 8).astype(np.float32) * 0.3
    out = np.asarray(jsc.inverse_conv(jnp.asarray(coarse), want[3], want[4], jnp.asarray(wi)))
    got_i = tsc.inverse_conv(T(coarse), got["parent_of"], got["child_slot"], T(wi)).numpy()
    np.testing.assert_allclose(got_i, out, rtol=1e-5, atol=1e-5)


def test_v1m2_momenta_and_v1m3_raise():
    """SpUNet-v1m2: block norms momentum 0.1, the stem, transition and
    projection norms 0.02, eps 1e-5, as the JAX package's fields say.
    SpUNet-v1m3 (PDNorm, tests/test_torch_port_ppt.py) puts a PDBatchNorm at
    every norm, at PDNorm's own eps 1e-3 and momentum 0.01 whatever
    `bn_eps` / `bn_momentum` say, as the JAX package does; enc_mode raises."""
    cfg = dict(_cfg("gather")["backbone"], type="SpUNet-v1m2")
    m = MODELS.build(cfg)
    jcls = jspunet.SpUNetBNMomentum
    assert (m.enc[0].block0.bn1.momentum, m.enc[0].block0.bn1.eps) == (jcls.bn_momentum, jcls.bn_eps)
    for norm in (m.conv_input[1], m.down[0][1], m.up[2][1], m.dec[1].block0.proj[1]):
        assert (norm.momentum, norm.eps) == (jcls.transition_bn_momentum, jcls.bn_eps)
    m1 = MODELS.build(_cfg("gather")["backbone"])
    assert (m1.enc[0].block0.bn1.momentum, m1.conv_input[1].momentum, m1.conv_input[1].eps) == (0.01, 0.01, 1e-3)
    for pd in (dict(type="SpUNet-v1m3"), dict(pdnorm_bn=True, bn_eps=1e-5, bn_momentum=0.1)):
        m3 = MODELS.build(dict(_cfg("gather")["backbone"], **pd))
        norms = [m3.conv_input[1], m3.down[0][1], m3.up[2][1], m3.enc[1].block0.bn1, m3.dec[0].block0.bn2,
                 m3.dec[1].block0.proj[1]]
        assert all(type(n).__name__ == "PDBatchNorm" and len(n.bns) == 3 for n in norms)
        assert {(bn.eps, bn.momentum) for n in norms for bn in n.bns} == {(1e-3, 0.01)}
    with pytest.raises(NotImplementedError):
        MODELS.build(dict(_cfg("gather")["backbone"], enc_mode=True))


def test_mink_unet_registrations_match_jax():
    """The 20 MinkUNet presets: the same names as the JAX registry, each
    with its layers and channels."""
    names = sorted(n for n in JAX_MODELS.module_dict if n.startswith("MinkUNet"))
    assert len(names) == 20
    assert names == sorted(n for n in MODELS.module_dict if n.startswith("MinkUNet"))
    for name in names:
        m = MODELS.build(dict(type=name, in_channels=6, num_classes=13))
        layers = jspunet._MINK_PRESETS[name[:-1]]["layers"]
        channels = jspunet._MINK_CHANNELS[name[-1]]
        assert m.layers == tuple(layers)
        assert [len(list(s.children())) for s in m.enc] == list(layers[:4])
        assert m.final.weight.shape == (1, channels[-1], 13)
        assert m.up[3][0].weight.shape == (8, channels[3], channels[4])
    assert tspunet._MINK_CHANNELS == jspunet._MINK_CHANNELS
