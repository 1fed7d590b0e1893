"""The port's train step against the JAX package on the CPU.

The slice as a whole: one train step of the small PT-v3m1 + DefaultSegmentorV2
(the model of tests/test_torch_port_ptv3.py: 3 stages, patch 128, the
block-dense engine at stage 0) with cross-entropy + Lovász, against
`jax.value_and_grad` of the JAX segmentor with the same weights
(`params_from_jax`), then AdamW + OneCycle on both sides. And the pieces:
the block conv's gradients, the losses, MaskedBatchNorm in train mode,
DropPath, the optimizer and scheduler, the patch-attention autograd function.

JAX runs as its own tests run it on the CPU: the dense XLA attention path and
`lax.conv` for the model, Pallas in interpret mode for the kernels."""

import ctypes
import ctypes.util
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_reference_oracle import _surface_scene  # noqa: E402
from test_torch_port_ops import T, _kb, _scene, _tables  # noqa: E402

from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.models.losses import build_criteria as jax_build_criteria  # noqa: E402
from pointcept_tpu.models.modules import MaskedBatchNorm as JaxMaskedBatchNorm  # noqa: E402
from pointcept_tpu.models.utils.convert import convert_state_dict  # noqa: E402
from pointcept_tpu.ops import block_conv as jbc  # noqa: E402
from pointcept_tpu.ops import serialization as jser  # noqa: E402
from pointcept_tpu.utils.optimizer import build_optimizer as jax_build_optimizer  # noqa: E402
from pointcept_tpu.utils.scheduler import build_scheduler as jax_build_scheduler  # noqa: E402
from pointcept_tpu_torch.engines import build_train_step, make_point_batch  # noqa: E402
from pointcept_tpu_torch.models import build_model  # noqa: E402
from pointcept_tpu_torch.models.losses import build_criteria  # noqa: E402
from pointcept_tpu_torch.models.modules import DropPath, MaskedBatchNorm  # noqa: E402
from pointcept_tpu_torch.models.utils import structure  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.ops import block_conv as tbc  # noqa: E402
from pointcept_tpu_torch.ops.kernels import (  # noqa: E402
    PatchAttention, patch_attention_bwd_plain, patch_attention_fwd_plain,
)
from pointcept_tpu_torch.utils import build_optimizer, build_scheduler  # noqa: E402

CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
OPTIMIZER = dict(type="AdamW", lr=0.006, weight_decay=0.05)
PARAM_DICTS = [dict(keyword="block", lr=0.0006)]
SCHEDULER = dict(type="OneCycleLR", max_lr=[0.006, 0.0006], pct_start=0.05, anneal_strategy="cos",
                 div_factor=10.0, final_div_factor=1000.0)


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


@pytest.fixture(scope="module", autouse=True)
def _keep_freed_blocks():
    """The CPU train steps allocate and free hundreds of tensors of a few
    MB. glibc hands blocks that large back to the kernel on free, so every
    step faults its pages in afresh, which on some hosts costs several times
    the step's arithmetic. Keep them in the heap while this module runs."""
    mallopt = getattr(ctypes.CDLL(ctypes.util.find_library("c")), "mallopt", None)
    trim, mmap = -1, -3  # M_TRIM_THRESHOLD, M_MMAP_THRESHOLD
    if mallopt is not None:
        mallopt(mmap, 32 << 20)
        mallopt(trim, 1 << 30)
    yield
    if mallopt is not None:
        mallopt(mmap, 128 << 10)
        mallopt(trim, 128 << 10)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cos(got, want):
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


# ------------------------------------------------------------ the slice


def _cfg(amp, shuffle, sorted_layout):
    backbone = dict(
        type="PT-v3m1", in_channels=6, order=("z", "z-trans", "hilbert", "hilbert-trans"),
        stride=(2, 2), enc_depths=(1, 1, 2), enc_channels=(32, 64, 256), enc_num_head=(2, 4, 16),
        enc_patch_size=(128,) * 3, dec_depths=(1, 1), dec_channels=(32, 64), dec_num_head=(2, 4),
        dec_patch_size=(128,) * 2, mlp_ratio=2, drop_path=0.0, shuffle_orders=shuffle,
        sorted_layout=sorted_layout, serialize_depth=7, pool_capacity_factors=(0.2, 0.45),
        conv_engine="block", block_bits=2, block_capacity_factor=1 / 24,
        block_engine_min_points=8192, amp=amp,
    )
    return dict(type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=32,
                backbone=backbone, criteria=CRITERIA)


def _labelled_scene():
    """One surface scene (capacity 13,312); labels 0-11 of 13 classes (class
    12 absent), a tenth of the points ignored (-1)."""
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
    arrays = _labelled_scene()
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    model = jax_build_model(_cfg(False, False, True))
    variables = jax.jit(lambda r: model.init(r, pb, train=False))({"params": jax.random.PRNGKey(0)})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rs = np.random.RandomState(5)  # non-trivial running statistics
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5, variables["batch_stats"]
    )
    return dict(arrays=arrays, pb=pb, params=params, stats=stats)


def _jax_optimizer(params):
    return jax_build_optimizer(OPTIMIZER, params, jax_build_scheduler(SCHEDULER, total_steps=1000),
                               PARAM_DICTS)


def _jax_step(weights, cfg, monkeypatch):
    """One JAX train step: loss, grads, the new running statistics, and the
    order permutations the forward drew."""
    model = jax_build_model(cfg)
    drawn = []
    permutation = jax.random.permutation

    def recording(key, x, *args, **kwargs):
        out = permutation(key, x, *args, **kwargs)
        drawn.append(out)
        return out

    monkeypatch.setattr(jax.random, "permutation", recording)

    def loss_fn(params):
        drawn.clear()
        out, upd = model.apply({"params": params, "batch_stats": weights["stats"]}, weights["pb"],
                               train=True, rngs={"shuffle": jax.random.PRNGKey(1),
                                                 "dropout": jax.random.PRNGKey(2)},
                               mutable=["batch_stats", "diagnostics"])
        return out["loss"], (upd["batch_stats"], list(drawn))

    (loss, (stats, perms)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        weights["params"])
    monkeypatch.setattr(jax.random, "permutation", permutation)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(loss=float(loss), grads=tree(grads), stats=tree(stats),
                perms=[np.asarray(p) for p in perms])


def _port_step(weights, cfg, perms, monkeypatch):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(weights["params"], weights["stats"]), strict=True)
    replay = iter(perms)
    monkeypatch.setattr(structure, "order_permutation",
                        lambda n, generator: torch.as_tensor(np.array(next(replay))).long())
    optimizer = build_optimizer(OPTIMIZER, model, PARAM_DICTS)
    scheduler = build_scheduler(SCHEDULER, optimizer, total_steps=1000)
    step = build_train_step(model, optimizer, scheduler)
    res = step(make_point_batch(weights["arrays"], 1, device="cpu"), torch.Generator().manual_seed(0))
    assert next(replay, None) is None, "the port drew fewer order permutations than JAX"
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return dict(loss=float(res["loss"]), grads=grads, model=model,
                overflow=(int(res["pool_overflow"]), int(res["block_overflow"])))


# Per-tensor gradient bounds: relative L2 error and cosine. Measured on this
# scene, port against JAX (f32 / AMP): loss 8e-6 / 5e-5; worst tensor 2.7e-2 /
# 1.1e-1, cosine > 0.9996 / 0.994. The gradients are that sensitive by
# nature: conv and attention operands round to bf16 and pooling takes a max,
# so a 1e-6 relative change of the input moves the port's own gradients by
# 3e-2 (f32) and 6e-2 (AMP) in the same measure.
BOUNDS = {False: dict(loss=2e-2, grad=5e-2, cos=0.999), True: dict(loss=1e-1, grad=1.5e-1, cos=0.99)}


@pytest.mark.parametrize("shuffle", [False, True], ids=["unshuffled", "shuffled"])
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_train_step_matches_jax(weights, amp, shuffle, monkeypatch):
    """drop_path 0; unshuffled with sorted_layout=False, or shuffled with
    JAX's permutations replayed through `order_permutation`."""
    cfg = _cfg(amp, shuffle, sorted_layout=False)
    want = _jax_step(weights, cfg, monkeypatch)
    assert len(want["perms"]) == (3 if shuffle else 0)  # serialization + 2 poolings
    got = _port_step(weights, cfg, want["perms"], monkeypatch)
    assert got["overflow"][0] > 0 and got["overflow"][1] > 0  # the capacities overflow
    b = BOUNDS[amp]
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - want["loss"]) / abs(want["loss"]) < b["loss"], (got["loss"], want["loss"])

    jgrads = {n: g.numpy() for n, g in params_from_jax(want["grads"], {}).items()}
    assert set(jgrads) == set(got["grads"])
    # biases that feed only train-mode BatchNorms have zero gradient in exact
    # arithmetic (found as the tensors whose f32 port gradient is below 1e-6
    # of the largest): both sides hold rounding noise there, compared to the
    # largest gradient
    f32 = got if not amp else _port_step(weights, _cfg(False, shuffle, False), want["perms"],
                                         monkeypatch)
    gmax = max(np.abs(g).max() for g in f32["grads"].values())
    vanishing = {n for n, g in f32["grads"].items() if np.abs(g).max() < 1e-6 * gmax}
    assert 0 < len(vanishing) < 20
    bad = {}
    for name, g in got["grads"].items():
        w = jgrads[name]
        if name in vanishing:
            if max(np.abs(g).max(), np.abs(w).max()) > 1e-3 * gmax:
                bad[name] = "vanishing gradient above the noise floor"
            continue
        err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        if not (err < b["grad"] and _cos(g, w) > b["cos"]):
            bad[name] = (err, _cos(g, w))
    assert not bad, bad

    # the update: JAX's optimizer chain applied to the port's gradients gives
    # the port's updated weights (param groups by keyword, OneCycle step 0,
    # decoupled weight decay), to f32 rounding
    sd = {k: v.numpy() for k, v in got["model"].state_dict().items()}
    port_grads, _, unmatched = convert_state_dict(got["grads"], "PT-v3m1")
    assert unmatched == []
    tx = _jax_optimizer(weights["params"])
    updates, _ = tx.update(port_grads, tx.init(weights["params"]), weights["params"])
    want_sd = params_from_jax(optax.apply_updates(weights["params"], updates), want["stats"])
    moved = 0
    for name, p in got["model"].named_parameters():
        np.testing.assert_allclose(sd[name], want_sd[name].numpy(), rtol=1e-6, atol=1e-8, err_msg=name)
        moved += int(not np.array_equal(sd[name], params_from_jax(weights["params"], {})[name].numpy()))
    assert moved == len(sd) - sum(k.endswith(("running_mean", "running_var")) for k in sd)
    # the running statistics against JAX's (measured 9e-5 / 4e-3 relative)
    for name in sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name], want_sd[name].numpy(), rtol=1e-2 if amp else 1e-3,
                                       atol=1e-5, err_msg=name)


def test_updated_state_round_trips_through_jax_converter(weights, monkeypatch):
    """After a train step, the port's state dict maps through the JAX
    converter onto the JAX trees exactly, running statistics included."""
    cfg = _cfg(False, True, sorted_layout=False)
    got = _port_step(weights, cfg, [np.random.RandomState(i).permutation(4) for i in range(3)],
                     monkeypatch)
    sd = {k: v.numpy() for k, v in got["model"].state_dict().items()}
    params, stats, unmatched = convert_state_dict(sd, "PT-v3m1")
    assert unmatched == []
    back = params_from_jax(params, stats)
    assert set(back) == set(sd)
    for name, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[name], err_msg=name)
    assert not np.array_equal(sd["backbone.embedding.stem.norm.running_mean"],
                              params_from_jax(weights["params"], weights["stats"])[
                                  "backbone.embedding.stem.norm.running_mean"].numpy())


def test_labelled_two_scene_step_and_seeded_repeat(weights):
    """Two scenes in one batch, the config's drop path and shuffled orders:
    finite loss and gradients, and the same generator seed gives the same
    step."""
    arrays = weights["arrays"]
    two = {k: np.concatenate([v, v]) for k, v in arrays.items()}
    two["batch"] = np.concatenate([arrays["batch"], np.where(arrays["batch"] >= 0, 1, -1)])
    two["coord"][len(arrays["batch"]):] += 0.5  # the second scene elsewhere in the room
    cfg = _cfg(False, True, sorted_layout=False)
    cfg["backbone"].update(drop_path=0.3, pool_capacity_factors=(0.45, 0.45), block_capacity_factor=1 / 8)
    losses = []
    for _ in range(2):
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        optimizer = build_optimizer(OPTIMIZER, model, PARAM_DICTS)
        step = build_train_step(model, optimizer, build_scheduler(SCHEDULER, optimizer, 1000))
        res = step(make_point_batch(two, 2, device="cpu"), torch.Generator().manual_seed(11))
        grads = [p.grad for p in model.parameters()]
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
        losses.append(float(res["loss"]))
        assert int(res["pool_overflow"]) == 0 and int(res["block_overflow"]) == 0
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


# ------------------------------------------------------------ block conv


@pytest.mark.parametrize("bb,m,identity", [(2, 1024, True), (2, 128, False), (3, 128, True)])
def test_block_subm_conv_grads_match_jax(bb, m, identity):
    """d/dfeat, d/dweight, d/dbias of the block conv against `jax.grad` of the
    JAX block conv (bf16 compute on both sides); padding rows and the points
    of overflowed blocks get exactly zero gradient on both sides."""
    depth, kernel = 9, 3
    grid, batch = _scene(7 * m + bb, cap=2048, depth=depth)
    j, t, grid, batch, mask = _tables(grid, batch, depth, m, bb, identity)
    rng = np.random.RandomState(m + bb)
    feat = rng.randn(len(grid), 8).astype(np.float32)
    w = (rng.randn(kernel**3, 8, 4) * 0.1).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    cot = rng.randn(len(grid), 4).astype(np.float32)

    def f(x, ww, bb_):
        return jnp.sum(jbc.block_subm_conv(x, j, ww, bb_, kernel_size=kernel) * cot)

    want = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(feat), jnp.asarray(w),
                                                                 jnp.asarray(b))]
    tf, tw, tb = (T(a).requires_grad_() for a in (feat, w, b))
    (tbc.block_subm_conv(tf, t, tw, tb, kernel_size=kernel) * T(cot)).sum().backward()
    got = [tf.grad.numpy(), tw.grad.numpy(), tb.grad.numpy()]
    dead = ~mask | (t["slot"].numpy() >= t["nbr"].shape[0] * (1 << (3 * bb)))
    assert dead.sum() > 0
    assert not got[0][dead].any() and not want[0][dead].any()
    if m == 128:
        assert int(t["overflow"]) > 0 and (mask & dead).any()  # overflow rows are among them
    # both round the conv operands and the cotangent to bf16 (2^-8 relative)
    # and sum in f32; measured max error 0.4% of the largest gradient
    for g, wt in zip(got, want):
        assert _rel(g, wt) < 1e-2, _rel(g, wt)


@pytest.mark.parametrize("m,halo", [(1024, 1), (128, 1), (1024, 2)])
def test_halo_expand_and_vjp_match_jax(m, halo):
    """`HaloExpand` (one gather) against the JAX package's 27-region
    `_halo_expand`, and its VJP (pulls from the reading tiles) against
    `jax.vjp` of it on every occupied block; with overflowed blocks (m 128).
    The zero tile and the blocks past the occupied ones hold zeros, as the
    fill leaves them, and their cotangent is read by nothing."""
    depth, bb = 9, 2
    grid, batch = _scene(11 + m + halo, cap=2048, depth=depth)
    _, t, _, _, _ = _tables(grid, batch, depth, m, bb, True)
    nbr = t["nbr"].numpy()
    nb = nbr.shape[0]
    nbr_ext = np.concatenate([nbr, np.full((1, 27), nb, nbr.dtype)])
    occupied = nbr[:, 13] == np.arange(nb)
    assert (nbr[occupied] == nb).any()  # missing neighbours read the zero tile
    assert (~occupied).any() == (m == 1024)  # empty block rows, or every block taken (overflow)
    rng = np.random.RandomState(m + halo)
    dense = rng.randn(nb + 1, 4, 4, 4, 5).astype(np.float32)
    dense[nb] = 0
    dense[:nb][~occupied] = 0
    hsz = 4 + 2 * halo
    g = rng.randn(nb + 1, hsz, hsz, hsz, 5).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jbc._halo_expand(d, jnp.asarray(nbr_ext), halo), jnp.asarray(dense))
    (want_g,) = vjp(jnp.asarray(g))
    td = T(dense).requires_grad_()
    got = tbc.HaloExpand.apply(td, T(nbr_ext), halo)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got_g,) = torch.autograd.grad(got, td, T(g))
    # f32 sums of up to 8 terms in another order
    np.testing.assert_allclose(got_g[:nb][T(occupied)].numpy(), np.asarray(want_g)[:nb][occupied],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_valid_grads_match_autograd(k, dtype):
    """`ConvValid`: the input gradient as a forward conv of the padded
    cotangent, the weight gradient from `convolution_backward`, against the
    autograd VJP of `F.conv3d`."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(k)
    x = T(rng.randn(7, 8, k + 3, k + 3, k + 3).astype(np.float32)).to(dt).requires_grad_()
    w = T(rng.randn(6, 8, k, k, k).astype(np.float32)).to(dt).requires_grad_()
    g = T(rng.randn(7, 6, 4, 4, 4).astype(np.float32)).to(dt)
    got = torch.autograd.grad(tbc.ConvValid.apply(x, w), (x, w), g)
    want = torch.autograd.grad(torch.nn.functional.conv3d(x, w), (x, w), g)
    # the same products summed in another order (measured 7e-7 in f32), then
    # rounded to bf16 (measured 1.0e-5 of the largest: one element one ulp off)
    tol = 1e-5 if dtype == "float32" else 2**-8
    for a, b in zip(got, want):
        assert _rel(a.float().numpy(), b.float().numpy()) < tol


def test_take_rows_vjp_sums_duplicates():
    """`TakeRows` (the attention's slot gathers, the gather conv's
    neighbour gather): forward is ``x[idx]``, the VJP sums the cotangents of
    repeated rows, thousands of them included."""
    from pointcept_tpu_torch.ops.segment_ops import TakeRows

    rng = np.random.RandomState(0)
    idx = np.concatenate([rng.randint(0, 300, 500), np.zeros(3000, np.int64)])
    for dt in (torch.float32, torch.bfloat16):
        x = T(rng.randn(300, 6).astype(np.float32)).to(dt).requires_grad_()
        g = T(rng.randn(len(idx), 6).astype(np.float32)).to(dt)
        y = TakeRows.apply(x, T(idx))
        assert torch.equal(y, x[T(idx)])
        (got,) = torch.autograd.grad(y, x, g)
        want = np.zeros((300, 6))
        np.add.at(want, idx, g.double().numpy())
        assert got.dtype == dt
        # f32 accumulation, rounded once to the row dtype
        tol = 1e-5 if dt == torch.float32 else 2 ** -8
        assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(want).max()


def test_block_tables_resorted_by_z_bit_identical():
    """`curve_is_z=False` (shuffled orders: order 0 may be any curve): the
    tables re-sort by the z curve, bit-identical to the JAX package's."""
    depth, m, bb = 9, 1024, 2
    grid, batch = _scene(5, cap=2048, depth=depth)
    keys = np.asarray(jser.encode(jnp.asarray(grid), jnp.asarray(_kb(batch)), depth, "hilbert"))
    order = np.asarray(jser.argsort_keys(jnp.asarray(keys), depth))
    mask = batch >= 0
    j = jbc.build_block_tables(jnp.asarray(keys), jnp.asarray(order), jnp.asarray(grid),
                               jnp.asarray(mask), depth, m, bb, curve_is_z=False, count_overflow=True)
    t = tbc.build_block_tables(T(keys), T(order), T(grid), T(mask), depth, m, bb, curve_is_z=False)
    assert not t["identity_order0"]
    for name in ("slot", "nbr", "rc_sorted", "fill_start", "block_grid", "overflow", "order0"):
        np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]), err_msg=name)


# ------------------------------------------------------------ losses, norms


def _logits_and_labels(n=3000, c=13, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 2).astype(np.float32)
    labels = rng.randint(0, c - 1, n).astype(np.int32)  # class c-1 absent
    labels[rng.rand(n) < 0.15] = -1
    return logits, labels


@pytest.mark.parametrize("loss", ["CrossEntropyLoss", "LovaszLoss", "both"])
def test_losses_and_logit_grads_match_jax(loss):
    cfg = CRITERIA if loss == "both" else [c for c in CRITERIA if c["type"] == loss]
    logits, labels = _logits_and_labels()
    jcrit = jax_build_criteria(cfg)
    want, want_g = jax.value_and_grad(lambda x: jcrit(x, jnp.asarray(labels)))(jnp.asarray(logits))
    x = T(logits).requires_grad_()
    got = build_criteria(cfg)(x, T(labels))
    got.backward()
    # f32 on both sides; summation order differs (measured ~1e-7)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_batch_norm_train_matches_jax(dtype):
    """Output, input gradient and both running statistics, with a mask."""
    rng = np.random.RandomState(1)
    x = (rng.randn(500, 16) * 3 + 5).astype(np.float32)
    mask = rng.rand(500) < 0.7
    x[~mask] = 1e4  # padding rows hold garbage that must not reach the statistics
    scale, bias = rng.rand(16).astype(np.float32) + 0.5, rng.randn(16).astype(np.float32)
    mean0, var0 = rng.randn(16).astype(np.float32), rng.rand(16).astype(np.float32) + 0.5
    cot = rng.randn(500, 16).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    bn = JaxMaskedBatchNorm()

    def f(xx):
        y, upd = bn.apply(variables, xx.astype(jdt), jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd["batch_stats"])

    (_, (want, stats)), want_g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    tbn = MaskedBatchNorm(16)
    tbn.load_state_dict(dict(weight=T(scale), bias=T(bias), running_mean=T(mean0), running_var=T(var0)))
    tbn.train()
    tx = T(x).requires_grad_()
    y = tbn(tx.to(getattr(torch, dtype)), T(mask))
    (y.float() * T(cot)).sum().backward()
    assert y.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2  # bf16: one ulp of the normalised output
    np.testing.assert_allclose(y.float().detach().numpy()[mask], np.asarray(want, np.float32)[mask],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6, atol=1e-6)
    # the input gradient, padding rows included (they are normalised too)
    assert _rel(tx.grad.numpy(), np.asarray(want_g)) < (1e-4 if dtype == "float32" else 3e-2)


def test_drop_path_semantics():
    x = torch.randn(4000, 8)
    dp = DropPath(0.25).train()
    a = dp(x, torch.Generator().manual_seed(4))
    b = dp(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)  # the same seed gives the same mask
    kept = (a != 0).all(dim=1)
    assert torch.equal(a[kept], x[kept] / 0.75)  # kept rows scaled by 1 / keep
    assert not a[~kept].any()
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert torch.equal(DropPath(0.0).train()(x), x)  # rate 0
    assert torch.equal(dp.eval()(x), x)  # eval
    with pytest.raises(ValueError):
        dp.train()(x)  # train mode needs an explicit generator


# ------------------------------------------------------------ optimizer


def test_adamw_onecycle_param_groups_match_jax():
    """Three AdamW + OneCycle steps on a two-leaf model with a `block`
    keyword group, the same gradients fed to both sides."""
    rng = np.random.RandomState(2)
    w0 = {"block": rng.randn(6, 5).astype(np.float32), "head": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in w0.items()} for _ in range(3)]
    total = 100  # short cycle: warm-up over 5 steps, so the lr changes at every step
    jparams = {"block": {"kernel": jnp.asarray(w0["block"])}, "head": {"bias": jnp.asarray(w0["head"])}}
    tx = jax_build_optimizer(OPTIMIZER, jparams, jax_build_scheduler(SCHEDULER, total_steps=total),
                             PARAM_DICTS)
    state = tx.init(jparams)

    model = torch.nn.Module()
    model.block = torch.nn.Module()
    model.block.weight = torch.nn.Parameter(T(w0["block"]))
    model.head = torch.nn.Parameter(T(w0["head"]))
    optimizer = build_optimizer(OPTIMIZER, model, PARAM_DICTS)
    assert [g["lr"] for g in optimizer.param_groups] == [0.006, 0.0006]
    scheduler = build_scheduler(SCHEDULER, optimizer, total_steps=total)
    for g in grads:
        jg = {"block": {"kernel": jnp.asarray(g["block"])}, "head": {"bias": jnp.asarray(g["head"])}}
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        model.block.weight.grad, model.head.grad = T(g["block"]), T(g["head"])
        optimizer.step()
        scheduler.step()
        np.testing.assert_allclose(model.block.weight.detach().numpy(), np.asarray(jparams["block"]["kernel"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(model.head.detach().numpy(), np.asarray(jparams["head"]["bias"]),
                                   rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ attention autograd


def test_patch_attention_function_backward_is_the_plain_backward():
    """torch.autograd.grad through `PatchAttention` on the CPU equals the
    plain backward on the forward's own statistics."""
    rng = np.random.RandomState(3)
    np_, k, c, h = 2, 128, 64, 4
    qkv = T(rng.randn(np_, k, 3 * c).astype(np.float32)).to(torch.bfloat16).requires_grad_()
    dout = T(rng.randn(np_, k, c).astype(np.float32)).to(torch.bfloat16)
    out = PatchAttention.apply(qkv, h, 0.25)
    (got,) = torch.autograd.grad(out, qkv, dout)
    o, m, l = patch_attention_fwd_plain(qkv.detach(), h, 0.25, stats=True)
    assert torch.equal(out, o)
    assert torch.equal(got, patch_attention_bwd_plain(qkv.detach(), o, dout, m, l, h, 0.25))
