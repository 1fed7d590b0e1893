"""The port's operators (pointcept_tpu_torch.ops, PointBatch) against the JAX
package on the CPU: the same numpy inputs through both.

Integer outputs (keys, orders, tables, rule maps) must be bit-identical.
Float outputs state their tolerance where they have one."""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcept_tpu.models.utils.structure import PointBatch as JPointBatch
from pointcept_tpu.ops import block_conv as jbc
from pointcept_tpu.ops import segment_ops as jseg
from pointcept_tpu.ops import serialization as jser
from pointcept_tpu.ops import sparse_conv as jsc
from pointcept_tpu_torch.models.utils.structure import PointBatch
from pointcept_tpu_torch.ops import block_conv as tbc
from pointcept_tpu_torch.ops import segment_ops as tseg
from pointcept_tpu_torch.ops import serialization as tser
from pointcept_tpu_torch.ops import sparse_conv as tsc

GOLDEN = np.load(osp.join(osp.dirname(__file__), "golden", "serialization_golden.npz"))
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


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


def _scene(seed, cap=1024, depth=8, n_scenes=2, fill=0.7):
    """Unique voxels (per scene) of `n_scenes` scenes, padded to `cap` rows;
    padding rows keep distinct grid coords so that every key is unique."""
    rng = np.random.RandomState(seed)
    flat = rng.choice(1 << 24, size=cap, replace=False)
    spread = max(1, (1 << depth) >> 8)  # coords span the whole depth, hi key bits included
    grid = (np.stack([flat >> 16, (flat >> 8) & 255, flat & 255], axis=1) * spread).astype(np.int32)
    grid = np.minimum(grid, (1 << depth) - 1)
    # clustered half: a dense surface-like slab so blocks and neighbours are populated
    nc = cap // 2
    base = rng.randint(0, (1 << depth) - 16, 3)
    slab = np.unique(base + rng.randint(0, 12, (nc * 2, 3)), axis=0)[:nc]
    grid[: len(slab)] = slab
    key = grid[:, 0].astype(np.int64) << 20 | grid[:, 1].astype(np.int64) << 10 | grid[:, 2]
    _, first = np.unique(key, return_index=True)
    keep = np.zeros(cap, bool)
    keep[first] = True
    batch = np.where(rng.rand(cap) < fill, rng.randint(0, n_scenes, cap), -1).astype(np.int32)
    batch = np.where(keep, batch, -1)
    # padding rows: distinct coords far from the data
    pad = batch < 0
    grid[pad] = np.stack([np.arange(pad.sum()) % (1 << depth), np.full(pad.sum(), (1 << depth) - 1),
                          np.arange(pad.sum()) // (1 << depth)], 1)
    return grid, batch


def _kb(batch):
    return np.where(batch >= 0, batch, int(jser.BATCH_SENTINEL)).astype(np.int32)


@pytest.mark.parametrize("depth", [4, 8, 10, 12, 16])
@pytest.mark.parametrize("curve", ["z", "hilbert"])
def test_encode_matches_golden(curve, depth):
    coords = GOLDEN[f"coords_{depth}"].astype(np.int32)
    keys = tser.encode(T(coords), torch.zeros(len(coords), dtype=torch.int32), depth, curve).numpy()
    folded = jser.keys_to_int64_np(keys, depth) & ((1 << (3 * depth)) - 1)
    np.testing.assert_array_equal(folded, GOLDEN[f"{curve}_{depth}"])


@pytest.mark.parametrize("depth", [8, 12, 16])
@pytest.mark.parametrize("order", ORDERS)
def test_encode_matches_jax(order, depth):
    rng = np.random.RandomState(depth)
    grid = rng.randint(0, 1 << depth, (500, 3)).astype(np.int32)
    batch = rng.randint(0, 3, 500).astype(np.int32)
    want = np.asarray(jser.encode(jnp.asarray(grid), jnp.asarray(batch), depth, order))
    got = tser.encode(T(grid), T(batch), depth, order).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", [10, 16])
def test_sort_shift_invert_match_jax(depth):
    grid, batch = _scene(depth, cap=2048, depth=depth)
    for order in ORDERS:
        keys = np.asarray(jser.encode(jnp.asarray(grid), jnp.asarray(_kb(batch)), depth, order))
        want = np.asarray(jser.argsort_keys(jnp.asarray(keys), depth))
        got = tser.argsort_keys(T(keys), depth)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tser.invert_order(got).numpy(),
                                      np.asarray(jser.invert_order(jnp.asarray(want))))
        for bits in (3, 6, 12):
            np.testing.assert_array_equal(
                tser.key_shift_right(T(keys), bits).numpy(),
                np.asarray(jser.key_shift_right(jnp.asarray(keys), bits)),
            )


@pytest.mark.parametrize("patch", [32, 128])
def test_serialize_reorder_partition_match_jax(patch):
    grid, batch = _scene(3, cap=1024, depth=8, n_scenes=2)
    coord = grid.astype(np.float32) * 0.02
    jpb = JPointBatch(coord=jnp.asarray(coord), feat=None, grid_coord=jnp.asarray(grid),
                      batch=jnp.asarray(batch), num_scenes=2).serialize(ORDERS, 8)
    tpb = PointBatch(coord=T(coord), feat=None, grid_coord=T(grid), batch=T(batch),
                     num_scenes=2).serialize(ORDERS, 8)
    for name in ("serialized_keys", "serialized_order", "serialized_inverse"):
        np.testing.assert_array_equal(getattr(tpb, name).numpy(), np.asarray(getattr(jpb, name)))
    perm, inv = jpb.serialized_order[0], jpb.serialized_inverse[0]
    jpb = jpb.reorder(perm, inv, rebase_orders=(0, 2), rebase_keys=(0, 2))
    tpb = tpb.reorder(T(perm), T(inv), rebase_orders=(0, 2), rebase_keys=(0, 2))
    for oi in (0, 2):
        for a, b in zip(tpb.patch_partition(oi, patch), jpb.patch_partition(oi, patch)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tpb.padded_capacity(patch) == jpb.padded_capacity(patch)
    np.testing.assert_array_equal(tpb.scene_counts().numpy(), np.asarray(jpb.scene_counts()))


def test_with_grid_coord_matches_jax():
    rng = np.random.RandomState(4)
    coord = (rng.rand(600, 3) * 3).astype(np.float32)
    batch = np.where(rng.rand(600) < 0.9, rng.randint(0, 3, 600), -1).astype(np.int32)
    want = JPointBatch(coord=jnp.asarray(coord), feat=None, grid_coord=None, batch=jnp.asarray(batch),
                       num_scenes=3).with_grid_coord(0.05).grid_coord
    got = PointBatch(coord=T(coord), feat=None, grid_coord=None, batch=T(batch),
                     num_scenes=3).with_grid_coord(0.05).grid_coord
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_segment_reduce_matches_jax(reduce):
    rng = np.random.RandomState(0)
    data = rng.randn(300, 5).astype(np.float32)
    # segments 3, 7, 20 stay empty; ids >= 24 are dropped
    ids = rng.choice([i for i in range(30) if i not in (3, 7, 20)], 300).astype(np.int32)
    ids.sort()
    want = np.asarray(jseg.segment_reduce(jnp.asarray(data), jnp.asarray(ids), 24, reduce=reduce))
    got = tseg.segment_reduce(T(data), T(ids), 24, reduce=reduce).numpy()
    assert (got[[3, 7, 20]] == 0).all()
    # f32 sums in another order: a few ulps
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduce", ["sum", "mean", "min"])
def test_masked_segment_reduce_matches_jax(reduce):
    """Sonata's per-scene reductions: masked rows, ids outside the range,
    an empty segment; sums in a fixed order (no atomics)."""
    rng = np.random.RandomState(2)
    data = rng.randn(400, 3).astype(np.float32)
    ids = rng.randint(-1, 7, 400).astype(np.int32)  # segment 5 of 6 stays empty, -1 and 6 drop
    ids[ids == 5] = 6
    mask = rng.rand(400) < 0.8
    want = np.asarray(jseg.masked_segment_reduce(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(mask), 6,
                                                 reduce))
    got = tseg.masked_segment_reduce(T(data), T(ids), T(mask), 6, reduce).numpy()
    assert (got[5] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sorted_segment_mean_matches_jax():
    """The pooling's fixed-order mean (f64 prefix sums) against the JAX
    segment mean, on sorted ids with empty and dropped segments."""
    rng = np.random.RandomState(1)
    data = (rng.randn(300, 3) * 3).astype(np.float32)
    ids = np.sort(rng.choice([i for i in range(30) if i not in (3, 7, 20)], 300)).astype(np.int32)
    want = np.asarray(jseg.segment_reduce(jnp.asarray(data), jnp.asarray(ids), 24, reduce="mean"))
    got = tseg.sorted_segment_mean(T(data), T(ids), 24)
    assert got.dtype == torch.float32 and (got.numpy()[[3, 7, 20]] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel", [3, 5])
def test_neighbor_map_and_gather_conv_match_jax(kernel):
    depth = 8
    grid, batch = _scene(kernel, cap=1024, depth=depth)
    mask = batch >= 0
    want = np.asarray(jsc.build_subm_neighbor_map(jnp.asarray(grid), jnp.asarray(_kb(batch)),
                                                  jnp.asarray(mask), depth, kernel))
    got = tsc.build_subm_neighbor_map(T(grid), T(_kb(batch)), T(mask), depth, kernel)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[mask] >= 0).sum() > 2 * mask.sum()  # the slab gives real neighbours

    rng = np.random.RandomState(1)
    feat = rng.randn(len(grid), 8).astype(np.float32)
    w = (rng.randn(kernel**3, 8, 4) * 0.1).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    for dt_j, dt_t in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jsc.gather_conv(jnp.asarray(feat), jnp.asarray(want), jnp.asarray(w),
                                         jnp.asarray(b), compute_dtype=dt_j))
        out = tsc.gather_conv(T(feat), got, T(w), T(b), compute_dtype=dt_t).numpy()
        # identical products, f32 sums in another order
        np.testing.assert_allclose(out[mask], ref[mask], rtol=1e-5, atol=1e-5)


def test_k3_columns_and_offsets_match_jax():
    np.testing.assert_array_equal(tsc.k3_columns_of_k5(), jsc.k3_columns_of_k5())
    for k in (3, 5):
        np.testing.assert_array_equal(tsc.kernel_offsets(k), jsc.kernel_offsets(k))
    for bb in (2, 3):
        got = tbc.raster_of_morton(torch.arange(1 << (3 * bb), dtype=torch.int32), bb)
        np.testing.assert_array_equal(got.numpy(), jbc._raster_of_morton_lut(bb))


def _tables(grid, batch, depth, m, bb, identity):
    kb = _kb(batch)
    keys = np.asarray(jser.encode(jnp.asarray(grid), jnp.asarray(kb), depth, "z"))
    order = np.asarray(jser.argsort_keys(jnp.asarray(keys), depth))
    mask = batch >= 0
    if identity:  # the sorted layout: rows pinned to z-order
        grid, batch, keys, mask = grid[order], batch[order], keys[order], mask[order]
        order = np.arange(len(grid), dtype=np.int32)
    j = jbc.build_block_tables(jnp.asarray(keys), jnp.asarray(order), jnp.asarray(grid),
                               jnp.asarray(mask), depth, m, bb, identity_order0=identity,
                               count_overflow=True)
    t = tbc.build_block_tables(T(keys), T(order), T(grid), T(mask), depth, m, bb,
                               identity_order0=identity)
    return j, t, grid, batch, mask


@pytest.mark.parametrize("bb,m,identity", [(2, 1024, True), (2, 128, False), (3, 128, True)])
def test_block_tables_bit_identical(bb, m, identity):
    grid, batch = _scene(bb + m, cap=2048, depth=9)
    j, t, _, _, _ = _tables(grid, batch, 9, m, bb, identity)
    for name in ("slot", "nbr", "rc_sorted", "fill_start", "block_grid", "overflow"):
        np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]), err_msg=name)
    if m == 128:
        assert int(t["overflow"]) > 0  # capacity chosen to overflow


@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("bb", [2, 3])
def test_block_subm_conv_matches_jax_and_gather(kernel, bb):
    depth = 9
    grid, batch = _scene(10 * kernel + bb, cap=1024, depth=depth)
    j, t, grid, batch, mask = _tables(grid, batch, depth, 1024, bb, identity=True)
    rng = np.random.RandomState(kernel)
    feat = rng.randn(len(grid), 8).astype(np.float32)
    w = (rng.randn(kernel**3, 8, 4) * 0.1).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    nbr = np.asarray(jsc.build_subm_neighbor_map(jnp.asarray(grid), jnp.asarray(_kb(batch)),
                                                 jnp.asarray(mask), depth, kernel))
    ref = np.asarray(jsc.gather_conv(jnp.asarray(feat), jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(b)))
    # f32 compute: block layout against gather layout, as tests/test_block_conv.py
    got32 = tbc.block_subm_conv(T(feat), t, T(w), T(b), kernel_size=kernel,
                                compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got32[mask], ref[mask], rtol=2e-4, atol=2e-4)
    # bf16 compute (the model's): same bf16 operands and f32 sums as the JAX engine
    want = np.asarray(jbc.block_subm_conv(jnp.asarray(feat), j, jnp.asarray(w), jnp.asarray(b),
                                          kernel_size=kernel))
    got = tbc.block_subm_conv(T(feat), t, T(w), T(b), kernel_size=kernel).numpy()
    # the conv output is rounded to bf16 on both sides: one bf16 ulp (2^-8 relative)
    np.testing.assert_allclose(got[mask], want[mask], rtol=8e-3, atol=8e-3)
