"""The slice as a whole: DefaultSegmentorV2 + PT-v3m1 eval forward of the port
against the JAX package on the CPU, with the same weights carried across by
`params_from_jax`, and the weight round trip through the JAX converter.

Small model: 3 stages (the last at C = 256, so the wide-head shape runs),
patch 128, the block-dense engine with 4^3 blocks at stage 0 and the gather
engine below `block_engine_min_points`. Capacities are tight enough that the
block and pool overflow counters are nonzero, so their agreement means
something."""

import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_reference_oracle import _surface_scene  # noqa: E402

from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.models.utils.convert import convert_state_dict  # noqa: E402
from pointcept_tpu_torch.engines import make_point_batch  # noqa: E402
from pointcept_tpu_torch.models import build_model  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402


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


def _cfg(amp):
    backbone = dict(
        type="PT-v3m1", in_channels=6, order=("z", "z-trans", "hilbert", "hilbert-trans"),
        stride=(2, 2), enc_depths=(1, 1, 2), enc_channels=(32, 64, 256), enc_num_head=(2, 4, 16),
        enc_patch_size=(128,) * 3, dec_depths=(1, 1), dec_channels=(32, 64), dec_num_head=(2, 4),
        dec_patch_size=(128,) * 2, mlp_ratio=2, drop_path=0.0, shuffle_orders=False,
        serialize_depth=7, pool_capacity_factors=(0.2, 0.45), conv_engine="block", block_bits=2,
        block_capacity_factor=1 / 24, block_engine_min_points=8192, amp=amp,
    )
    return dict(type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=32, backbone=backbone,
                criteria=[dict(type="CrossEntropyLoss", ignore_index=-1)])


def _jax_overflow(diag):
    d = diag["diagnostics"]["backbone_module"]
    block = [int(v) for v in d["block_overflow"]]
    pool = [int(d[f"enc{s}_down"]["pool_overflow"][0]) for s in (1, 2)]
    return block, pool


@pytest.fixture(scope="module")
def ref():
    grid, feat = _surface_scene(span=60, seed=3)
    n = len(grid)
    cap = ((n + 255) // 256) * 256 + 256
    arrays = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                  grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32))
    arrays["coord"][:n] = grid * 0.02
    arrays["feat"][:n] = feat
    arrays["grid_coord"][:n] = grid
    arrays["batch"][:n] = 0
    pb = jax_point_batch({k: jax.numpy.asarray(v) for k, v in arrays.items()}, 1)
    model = jax_build_model(_cfg(False))
    variables = jax.jit(lambda r: model.init(r, pb, train=False))({"params": jax.random.PRNGKey(0)})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rs = np.random.RandomState(5)  # non-trivial running statistics
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5, variables["batch_stats"]
    )
    out = {}
    for amp in (False, True):
        m = jax_build_model(_cfg(amp))
        res, diag = jax.jit(lambda p, b: m.apply({"params": p, "batch_stats": b}, pb, train=False,
                                                 mutable=["diagnostics"]))(params, stats)
        out[amp] = (np.asarray(res["seg_logits"], np.float32), _jax_overflow(diag))
    return dict(arrays=arrays, valid=arrays["batch"] >= 0, params=params, stats=stats, out=out)


def _port(ref, amp):
    model = build_model(_cfg(amp), device="cpu")
    model.load_state_dict(params_from_jax(ref["params"], ref["stats"]), strict=True)
    return model(make_point_batch(ref["arrays"], 1, device="cpu"))


@pytest.mark.parametrize("amp", [False, True])
def test_logits_match_jax(ref, amp):
    res = _port(ref, amp)
    v = ref["valid"]
    want = ref["out"][amp][0][v]
    got = res["seg_logits"].float().numpy()[v]
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    agree = (got.argmax(1) == want.argmax(1)).mean()
    if amp:
        # bf16 activation stream: the two frameworks round it at different
        # points (torch after every op of the norms, GELUs and residual adds;
        # XLA may keep a fused chain in f32), so the streams drift by bf16
        # ulps through the U-Net (measured 1.5e-2 and 0.990 on this scene)
        assert err < 5e-2 and agree > 0.97, (err, agree)
    else:
        # f32 stream: only the bf16 conv/attention operands round, and the
        # JAX CPU path normalises p before rounding it where the port's flash
        # maths rounds the unnormalised p (measured 4.5e-3 and 0.998); the
        # bounds of tests/test_reference_oracle.py, tightened
        assert err < 1e-2 and agree > 0.99, (err, agree)


@pytest.mark.parametrize("amp", [False, True])
def test_overflow_counters_match_jax(ref, amp):
    diag = _port(ref, amp)["diagnostics"]
    block, pool = ref["out"][amp][1]
    assert [int(x) for x in diag["block_overflow"]] == block
    assert [int(x) for x in diag["pool_overflow"]] == pool
    assert sum(block) > 0 and sum(pool) > 0  # the capacities were chosen to overflow


def test_state_dict_round_trips_through_jax_converter(ref):
    model = build_model(_cfg(True), device="cpu")
    model.load_state_dict(params_from_jax(ref["params"], ref["stats"]), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert "backbone.embedding.stem.conv.weight" in sd
    assert "backbone.enc.enc0.block0.cpe.0.weight" in sd
    assert "backbone.dec.dec0.up.proj_skip.0.weight" in sd
    params, stats, unmatched = convert_state_dict(sd, "PT-v3m1")
    assert unmatched == []
    for got, want in ((params, ref["params"]), (stats, ref["stats"])):
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, a), (_, b) in zip(flat_g, flat_w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_two_scene_batch_matches_jax(ref):
    """Two scenes in one batch: per-scene patch partitions, pooling across the
    scene boundary, per-scene keys (f32 stream, the bounds above)."""
    g1, f1 = _surface_scene(span=56, seed=3)
    g2, f2 = _surface_scene(span=52, seed=8)
    n1, n2 = len(g1), len(g2)
    cap = ((n1 + n2 + 255) // 256) * 256 + 256
    arrays = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                  grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32))
    arrays["coord"][: n1 + n2] = np.concatenate([g1, g2]) * 0.02
    arrays["feat"][: n1 + n2] = np.concatenate([f1, f2])
    arrays["grid_coord"][: n1 + n2] = np.concatenate([g1, g2])
    arrays["batch"][:n1] = 0
    arrays["batch"][n1 : n1 + n2] = 1
    cfg = _cfg(False)
    cfg["backbone"].update(pool_capacity_factors=(0.45, 0.45), block_capacity_factor=1 / 8)
    jm = jax_build_model(cfg)
    pb = jax_point_batch({k: jax.numpy.asarray(v) for k, v in arrays.items()}, 2)
    want = np.asarray(jax.jit(lambda p, b: jm.apply({"params": p, "batch_stats": b}, pb, train=False))(
        ref["params"], ref["stats"])["seg_logits"], np.float32)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(ref["params"], ref["stats"]), strict=True)
    got = model(make_point_batch(arrays, 2, device="cpu"))["seg_logits"].float().numpy()
    v = arrays["batch"] >= 0
    err = np.abs(got[v] - want[v]).max() / np.abs(want[v]).max()
    agree = (got[v].argmax(1) == want[v].argmax(1)).mean()
    assert err < 1e-2 and agree > 0.99, (err, agree)


def test_labelled_batch_and_training_mode_raise(ref):
    """A labelled batch returns a loss, train mode runs (with a generator for
    the order shuffles), and the options that are not ported still raise."""
    model = build_model(_cfg(False), device="cpu")
    arrays = dict(ref["arrays"], segment=np.where(ref["valid"], 3, -1).astype(np.int32))
    res = model(make_point_batch(arrays, 1, device="cpu"))
    assert np.isfinite(float(res["loss"])) and not res["loss"].requires_grad
    cfg = _cfg(False)
    cfg["backbone"].update(shuffle_orders=True, drop_path=0.3)
    model = build_model(cfg, device="cpu").train()
    with pytest.raises(ValueError):
        model(make_point_batch(arrays, 1, device="cpu"))  # train mode needs a generator
    res = model(make_point_batch(arrays, 1, device="cpu"), generator=torch.Generator().manual_seed(0))
    res["loss"].backward()
    assert np.isfinite(res["loss"].item())
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    # (PDNorm is ported: tests/test_torch_port_ppt.py)
    # (RPE is ported: tests/test_torch_port_rpe.py; window attention still refuses it)
    for option in (dict(enable_rpe=True, scene_blocked=True), dict(rope_base=10000.0),
                   dict(proj_drop=0.1), dict(attn_drop=0.1), dict(scene_blocked=True)):
        bad = dict(_cfg(False), backbone=dict(_cfg(False)["backbone"], **option))
        with pytest.raises(NotImplementedError):
            build_model(bad, device="cpu")
