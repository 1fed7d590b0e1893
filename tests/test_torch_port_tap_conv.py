"""The fused block conv of the port against the JAX package on the CPU.

* `block_subm_conv(..., fused=True)` (fill, `FusedBlockConv`, take-back)
  against the JAX `block_subm_conv` with ``BLOCK_CONV_FUSED=1`` (the fused
  Pallas route, interpret mode): forward and the gradients of features and
  weight, at 4^3 and 8^3 blocks;
* `tap_conv_fwd_plain` / `tap_conv_dw_plain` (the CUDA kernels' arithmetic)
  against the Pallas `tap_conv` / `tap_conv_dw` on the same halos, in each
  of the TPU kernels' regimes (banded, sliced, tap-chunked);
* the gather conv's deterministic VJP (`NeighborGather`): equal to
  autograd's, on a rule map that is symmetric, padding rows included.

The kernels themselves run only on a card: tests/test_torch_port_kernels.py."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from pointcept_tpu.ops import block_conv as jbc  # noqa: E402
from pointcept_tpu.ops import serialization as jser  # noqa: E402
from pointcept_tpu.ops import sparse_conv as jsc  # noqa: E402
from pointcept_tpu.ops.pallas import tap_conv as jtc  # noqa: E402
from pointcept_tpu_torch.ops import block_conv as tbc  # noqa: E402
from pointcept_tpu_torch.ops import serialization as tser  # noqa: E402
from pointcept_tpu_torch.ops import sparse_conv as tsc  # noqa: E402
from pointcept_tpu_torch.ops.kernels import tap_conv as ttc  # noqa: E402
from pointcept_tpu_torch.ops.segment_ops import TakeRows  # noqa: E402


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


def _scene(seed, n=900, span=20, depth=7, capacity=1024):
    """Unique voxels in a span^3 box (a few 8^3 blocks, more 4^3 ones) and
    padding rows, as tests/test_tap_conv.py builds them."""
    rng = np.random.RandomState(seed)
    grid = np.unique(rng.randint(0, span, size=(n, 3)).astype(np.int32), axis=0)
    n = len(grid)
    grid = np.concatenate([grid, np.zeros((capacity - n, 3), np.int32)])
    batch = np.concatenate([np.zeros(n, np.int32), np.full(capacity - n, -1, np.int32)])
    return grid, batch, batch >= 0


def _tables(grid, batch, mask, depth, m, bb):
    kb = np.where(mask, batch, int(jser.BATCH_SENTINEL)).astype(np.int32)
    keys = np.asarray(jser.encode(jnp.asarray(grid), jnp.asarray(kb), depth, "z"))
    order = np.asarray(jser.argsort_keys(jnp.asarray(keys), depth))
    j = jbc.build_block_tables(jnp.asarray(keys), jnp.asarray(order), jnp.asarray(grid),
                               jnp.asarray(mask), depth, m, bb)
    t = tbc.build_block_tables(T(keys), T(order), T(grid), T(mask), depth, m, block_bits=bb)
    return j, t


# (k, Cin, Cout) as tests/test_tap_conv.py, each at 4^3 and 8^3 blocks, in
# f32 compute; bf16 compute (the model's) at the widest. Each case compiles
# the interpret-mode Pallas kernels anew (5-15 s on the CPU).
CONV_CASES = [(3, 8, 16), (5, 6, 16), (3, 128, 64)]
FUSED_CASES = [(k, cin, cout, bb, "float32") for k, cin, cout in CONV_CASES for bb in (2, 3)]
FUSED_CASES += [(3, 128, 64, 3, "bfloat16")]
CAPACITY = {2: 128, 3: 32}


@pytest.mark.parametrize("k,cin,cout,bb,dtype", FUSED_CASES)
def test_fused_block_conv_matches_jax(k, cin, cout, bb, dtype, monkeypatch):
    """Output and the gradients of features and weight; JAX's fused route
    is read when it is traced, so the variable is set before."""
    monkeypatch.setenv("BLOCK_CONV_FUSED", "1")
    grid, batch, mask = _scene(k + cin + bb)
    depth = 7
    j, t = _tables(grid, batch, mask, depth, CAPACITY[bb], bb)
    occupied = int((t["nbr"][:, 13] == torch.arange(t["nbr"].shape[0])).sum())
    assert 0 < occupied < CAPACITY[bb] and int(t["overflow"]) == 0  # empty tiles, none dropped
    rng = np.random.RandomState(cin)
    feat = rng.randn(len(grid), cin).astype(np.float32)
    w = (rng.randn(k**3, cin, cout) * (k**3 * cin) ** -0.5).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    cot = rng.randn(len(grid), cout).astype(np.float32) * mask[:, None]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)

    def f(x, ww):
        out = jbc.block_subm_conv(x, j, ww, jnp.asarray(b), kernel_size=k, compute_dtype=jdt)
        return jnp.sum(out * cot), out

    (_, want), want_g = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(feat), jnp.asarray(w))
    tf, tw = T(feat).requires_grad_(), T(w).requires_grad_()
    got = tbc.block_subm_conv(tf, t, tw, T(b), kernel_size=k, compute_dtype=tdt, fused=True)
    (got * T(cot)).sum().backward()
    m = mask
    if dtype == "float32":
        # the same f32 products summed in another order
        np.testing.assert_allclose(got.detach().numpy()[m], np.asarray(want)[m], rtol=1e-4, atol=1e-4)
        tol = 1e-3
    else:
        # bf16 tiles and conv output on both sides (one ulp 2^-8), f32 sums
        scale = np.abs(np.asarray(want)[m]).max()
        assert np.abs(got.detach().numpy()[m] - np.asarray(want)[m]).max() < 2e-2 * scale
        tol = 2e-2
    for g_, w_ in ((tf.grad.numpy(), np.asarray(want_g[0])), (tw.grad.numpy(), np.asarray(want_g[1]))):
        assert np.abs(g_ - w_).max() <= tol * np.abs(w_).max(), np.abs(g_ - w_).max() / np.abs(w_).max()
    assert not tf.grad.numpy()[~mask].any()  # padding rows read the zero tile


def _dense_inputs(bb, k, cin, cout, seed):
    """Filled tiles of a scene (zero outside the occupied blocks), the table
    with its zero-tile row, and a cotangent filled the same way; f32 values
    that bf16 holds exactly."""
    grid, batch, mask = _scene(seed)
    _, t = _tables(grid, batch, mask, 7, CAPACITY[bb], bb)
    b3 = 1 << (3 * bb)
    order = t["order0"].long()
    rng = np.random.RandomState(seed)

    def fill(c):
        x = T(rng.randn(len(grid), c).astype(np.float32)).to(torch.bfloat16).float()
        return tbc.block_fill(x[order].contiguous(), t["rc_sorted"], t["fill_start"], b3)

    m = t["nbr"].shape[0]
    nbr_ext = torch.cat([t["nbr"], torch.full((1, 27), m, dtype=torch.int32)])
    w = T((rng.randn(k**3, cin, cout) * 0.1).astype(np.float32)).to(torch.bfloat16).float()
    return fill(cin), nbr_ext, w, fill(cout)


# one case of each TPU regime (the fused cases above run the banded and
# sliced ones at both block sizes through `block_subm_conv`)
REGIME_CASES = [("banded", 3, 5, 6, 16), ("sliced", 2, 3, 128, 64), ("chunked", 3, 3, 16, 16)]


@pytest.mark.parametrize("regime,bb,k,cin,cout", REGIME_CASES)
def test_plain_tap_conv_matches_pallas(regime, bb, k, cin, cout, monkeypatch):
    """`tap_conv_fwd_plain` and `tap_conv_dw_plain` against `tap_conv` and
    `tap_conv_dw` on the halo of the same tiles (`_halo_expand_flat`); the
    chunked regime forced as tests/test_tap_conv.py forces it."""
    if regime == "chunked":
        monkeypatch.setattr(jtc, "_BANDED_MAX_W", 0)
        monkeypatch.setattr(jtc, "_SINGLE_MAX_W", 0)
        monkeypatch.setattr(jtc, "_CHUNK_MAX_W", 3 * 16 * 16 * 4)
    b = 1 << bb
    assert jtc._plan(b, k, cin, cout, 4) == {"banded": ("banded", 1), "sliced": ("sliced", 1),
                                              "chunked": ("sliced", 9)}[regime]
    dense, nbr_ext, w, g = _dense_inputs(bb, k, cin, cout, seed=cin + bb)
    r = nbr_ext.shape[0]
    hal = jbc._halo_expand_flat(jnp.asarray(dense.numpy()).reshape(r, b**3 * cin),
                                jnp.asarray(nbr_ext.numpy()), b, (k - 1) // 2, cin)
    want = np.asarray(jtc.tap_conv(hal, jnp.asarray(w.numpy()), b, k, cin))
    got = ttc.tap_conv_fwd_plain(dense, nbr_ext, w, b, k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # f32 sums in another order
    assert np.abs(want).max() > 0
    want_dw = np.asarray(jtc.tap_conv_dw(hal, jnp.asarray(g.numpy()), b, k, cin))
    got_dw = ttc.tap_conv_dw_plain(dense, nbr_ext, g, b, k).numpy()
    np.testing.assert_allclose(got_dw, want_dw, rtol=1e-4, atol=1e-4 * np.abs(want_dw).max())


@pytest.mark.parametrize("bb,k", [(2, 3), (3, 5)])
def test_fused_block_conv_backward_is_autograd_of_plain(bb, k):
    """`FusedBlockConv`'s VJP (the flipped-weight forward for the tiles, the
    weight-gradient function for the weight) against autograd through the
    plain forward, on the occupied tiles."""
    dense, nbr_ext, w, g = _dense_inputs(bb, k, 8, 12, seed=3 + bb)
    b = 1 << bb
    d1, w1 = dense.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(tbc.FusedBlockConv.apply(d1, nbr_ext, w1, b, k), (d1, w1), g)
    d2, w2 = dense.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(ttc.tap_conv_fwd_plain(d2, nbr_ext, w2, b, k), (d2, w2), g)
    rows = ttc.occupied_tiles(nbr_ext).repeat_interleave(b**3)
    np.testing.assert_allclose(got[0][rows].numpy(), want[0][rows].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-4, atol=1e-4)
    assert not got[0][~rows].any()


# ------------------------------------------------------------ gather conv VJP


def _rule_map(kernel, seed=0):
    from test_torch_port_ops import _kb
    from test_torch_port_ops import _scene as ops_scene

    depth = 8
    grid, batch = ops_scene(seed + kernel, cap=1024, depth=depth)
    mask = batch >= 0
    nbr = tsc.build_subm_neighbor_map(T(grid), T(_kb(batch)), T(mask), depth, kernel)
    return nbr, mask


@pytest.mark.parametrize("kernel", [3, 5])
def test_rule_map_is_symmetric_padding_rows_included(kernel):
    """nbr[i, k] = j exactly when nbr[j, K-1-k] = i; padding rows read
    nothing and no row reads them (the VJP pull relies on it)."""
    nbr, mask = _rule_map(kernel)
    n, kk = nbr.shape
    a = nbr.numpy()
    assert (~mask).sum() > 0 and (a[~mask] == -1).all()
    assert not np.isin(np.nonzero(~mask)[0], a[a >= 0]).any()
    i, k = np.nonzero(a >= 0)
    np.testing.assert_array_equal(a[a[i, k], kk - 1 - k], i)
    assert (a[mask] >= 0).sum() > 2 * mask.sum()  # real neighbours, not just the centre


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [3, 5])
def test_gather_conv_vjp_equals_autograd(kernel, dtype):
    """The pulled VJP of the neighbour gather against autograd's VJP of the
    plain masked gather: integer-valued inputs, so every summation order
    gives the same f32 sums, and the two must be equal."""
    nbr, mask = _rule_map(kernel, seed=1)
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(kernel)
    x = T(rng.randint(-8, 9, (nbr.shape[0], 6)).astype(np.float32)).to(dt)
    g = T(rng.randint(-8, 9, (nbr.shape[0], nbr.shape[1], 6)).astype(np.float32)).to(dt)
    x1 = x.clone().requires_grad_()
    y1 = tsc.NeighborGather.apply(x1, nbr)
    (got,) = torch.autograd.grad(y1, x1, g)
    x2 = x.float().requires_grad_()
    y2 = torch.where((nbr >= 0)[..., None], x2[torch.clamp(nbr, min=0).long()], 0.0)
    (want,) = torch.autograd.grad(y2, x2, g.float())
    assert torch.equal(y1.float(), y2.detach())
    assert got.dtype == dt
    assert torch.equal(got, want.to(dt))
    assert float(want.abs().max()) > 8  # rows read by several neighbours


def test_gather_conv_grads_match_jax():
    """The gather conv with the pulled VJP against `jax.grad` of the JAX
    gather conv (bf16 compute), features and weight."""
    nbr, mask = _rule_map(3, seed=2)
    rng = np.random.RandomState(2)
    feat = rng.randn(nbr.shape[0], 8).astype(np.float32)
    w = (rng.randn(27, 8, 4) * 0.1).astype(np.float32)
    cot = rng.randn(nbr.shape[0], 4).astype(np.float32)

    def f(x, ww):
        return jnp.sum(jsc.gather_conv(x, jnp.asarray(nbr.numpy()), ww, compute_dtype=jnp.bfloat16) * cot)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(feat), jnp.asarray(w))
    tf, tw = T(feat).requires_grad_(), T(w).requires_grad_()
    (tsc.gather_conv(tf, nbr, tw, compute_dtype=torch.bfloat16) * T(cot)).sum().backward()
    for g_, w_ in ((tf.grad.numpy(), np.asarray(want[0])), (tw.grad.numpy(), np.asarray(want[1]))):
        # bf16 operands on both sides, f32 sums in another order, one bf16 rounding
        assert np.abs(g_ - w_).max() <= 1e-2 * np.abs(w_).max()


@pytest.mark.parametrize("symmetric", [True, False], ids=["rule_map", "read_once"])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_gather_gemm_equals_unfused_autograd(symmetric, compute):
    """`GatherGEMM`, which keeps x rather than the gathered rows and gathers
    them again in its backward, against autograd over the unfused ops (the
    masked gather, the f32 matmul, the casts): output, input and weight
    gradients bit for bit."""
    nbr, _ = _rule_map(3, seed=3)
    if not symmetric:  # a table that reads each row at most once
        n = nbr.shape[0]
        flat = torch.randperm(n * nbr.shape[1], generator=torch.Generator().manual_seed(0))
        nbr = torch.where(flat.reshape(nbr.shape) < n, flat.reshape(nbr.shape), -1).to(torch.int32)
    rng = np.random.RandomState(4)
    cdt = None if compute is None else getattr(torch, compute)
    feat = T(rng.randn(nbr.shape[0], 8).astype(np.float32))
    w = T((rng.randn(27, 8, 5) * 0.2).astype(np.float32))
    cot = T(rng.randn(nbr.shape[0], 5).astype(np.float32))
    runs = []
    for fused in (True, False):
        x, ww = feat.clone().requires_grad_(), w.clone().requires_grad_()
        f = x if cdt is None else x.to(cdt)
        w2 = ww if cdt is None else ww.to(cdt)
        if fused:
            out = tsc.GatherGEMM.apply(f, nbr, w2, symmetric).to(x.dtype)
        else:
            if symmetric:
                g = tsc.NeighborGather.apply(f, nbr)
            else:
                g = TakeRows.apply(f, torch.clamp(nbr.long(), min=0).reshape(-1)).reshape(*nbr.shape, 8)
                g = torch.where((nbr >= 0)[..., None], g, torch.zeros((), dtype=g.dtype))
            out = (g.reshape(nbr.shape[0], -1).float() @ w2.reshape(-1, 5).float()).to(x.dtype)
        runs.append((out.detach(),) + torch.autograd.grad(out, (x, ww), cot))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert float(runs[0][1].abs().max()) > 0 and float(runs[0][2].abs().max()) > 0
