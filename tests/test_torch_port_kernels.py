"""The port's kernels: each plain PyTorch version against the JAX kernel it
replaces (Pallas in interpret mode on the CPU, as tests/test_flash_attention.py
and tests/test_block_conv.py run them); and, on a CUDA card only, each CUDA
kernel against its plain version (marked `gpu`, skipped without a card).

The machine with the card has no JAX, so JAX is imported inside the CPU
tests only. On the card:

    python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from pointcept_tpu_torch.ops import kernels
from pointcept_tpu_torch.ops import serialization as tser
from pointcept_tpu_torch.ops.block_conv import build_block_tables


def _bf16(a):
    """numpy f32 values that bf16 represents exactly, and their torch tensor."""
    t = torch.as_tensor(a).to(torch.bfloat16)
    return t.float().numpy(), t


@pytest.mark.parametrize("c,h,kmajor", [(32, 2, True), (256, 16, False)])
def test_attention_plain_matches_flash_kernel(c, h, kmajor):
    import jax.numpy as jnp

    from pointcept_tpu.ops.pallas.flash_attention import flash_patch_attention, flash_patch_attention_kmajor

    rng = np.random.RandomState(c)
    np_, k = 3, 128
    d = c // h
    qkv, tq = _bf16(rng.randn(np_, k, 3 * c).astype(np.float32))
    scale = d**-0.5
    if kmajor:
        want = flash_patch_attention_kmajor(jnp.asarray(qkv).reshape(np_, k, 3, h, d), scale=scale)
        want = np.asarray(want, np.float32).reshape(np_, k, c)
    else:
        x = jnp.asarray(qkv).reshape(np_, k, 3, h, d)
        q, kk, v = (x[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
        want = np.asarray(flash_patch_attention(q, kk, v, scale=scale), np.float32)
        want = want.transpose(0, 2, 1, 3).reshape(np_, k, c)
    got = kernels.patch_attention_fwd(tq, h, scale).float().numpy()
    # bf16 compute tolerance, as tests/test_flash_attention.py
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


# (row of PERF.md's kernel table, JAX function, nP, K, C, H): the whole-K
# kernels at the tests' patch 128, the K-chunked ones at the main path's 1024
BWD_CASES = [
    ("5 _bwd_kernel_kmajor", "kmajor", 3, 128, 32, 2),
    ("6 _bwd_kernel_kmajor_chunked", "kmajor", 2, 1024, 32, 2),
    ("2 _bwd_kernel", "split", 2, 128, 256, 16),
    ("3 _bwd_kernel_chunked", "split", 1, 1024, 256, 16),
]


@pytest.mark.parametrize("row,layout,np_,k,c,h", BWD_CASES, ids=[c[0].split()[1] for c in BWD_CASES])
def test_attention_plain_backward_matches_jax_vjp(row, layout, np_, k, c, h):
    """The plain backward (the CUDA kernel's arithmetic) against `jax.vjp`
    of the Pallas flash attention, interpret mode, on the same bf16 qkv and
    cotangent. The TPU kernels take the row term as rowsum(dP o p) or from
    an o rebuilt of bf16 p, the port from the stored bf16 output, and the
    port rounds p and dS to bf16 as tensor-core operands; measured max error
    0.29% (row 5), 0.70% (row 6), 0.41% (row 2), 0.29% (row 3) of the
    largest gradient."""
    import jax
    import jax.numpy as jnp

    from pointcept_tpu.ops.pallas.flash_attention import flash_patch_attention, flash_patch_attention_kmajor

    rng = np.random.RandomState(k + c)
    d = c // h
    scale = d**-0.5
    qkv, tq = _bf16(rng.randn(np_, k, 3 * c).astype(np.float32))
    dout, tdo = _bf16(rng.randn(np_, k, c).astype(np.float32))

    def fwd(x):
        x5 = x.reshape(np_, k, 3, h, d)
        if layout == "kmajor":
            return flash_patch_attention_kmajor(x5, scale=scale).reshape(np_, k, c)
        q, kk, v = (x5[:, :, i].transpose(0, 2, 1, 3) for i in range(3))
        return flash_patch_attention(q, kk, v, scale=scale).transpose(0, 2, 1, 3).reshape(np_, k, c)

    _, vjp = jax.vjp(fwd, jnp.asarray(qkv, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(dout, jnp.bfloat16))
    want = np.asarray(want, np.float32)
    out, m, l = kernels.patch_attention_fwd(tq, h, scale, stats=True)
    got = kernels.patch_attention_bwd(tq, out, tdo, m, l, h, scale).float().numpy()
    assert np.abs(want).max() > 0
    assert (np.abs(got - want) <= 2e-2 * np.abs(want).max() + 2e-2 * np.abs(want)).all(), (
        row, float(np.abs(got - want).max() / np.abs(want).max()))


def _fill_inputs(bb, cin, seed=0, m=256):
    """Stage tables of a scene with a dense slab (the port's tables, which
    tests/test_torch_port_ops.py holds bit-identical to the JAX package's)
    and z-sorted bf16 features."""
    rng = np.random.RandomState(seed)
    depth, cap = 8, 1536
    flat = rng.choice(1 << (3 * depth), size=cap, replace=False)
    grid = np.stack([flat >> 16, (flat >> 8) & 255, flat & 255], 1).astype(np.int32)
    grid[: cap // 2] = np.unique(40 + rng.randint(0, 14, (cap, 3)), axis=0)[: cap // 2]
    key = grid[:, 0] * 65536 + grid[:, 1] * 256 + grid[:, 2]
    keep = np.zeros(cap, bool)
    keep[np.unique(key, return_index=True)[1]] = True
    mask = torch.as_tensor(keep & (rng.rand(cap) < 0.8))
    kb = torch.where(mask, 0, tser.BATCH_SENTINEL).to(torch.int32)
    keys = tser.encode(torch.as_tensor(grid), kb, depth, "z")
    order = tser.argsort_keys(keys, depth)
    t = build_block_tables(keys, order, torch.as_tensor(grid), mask, depth, m, bb)
    _, tfeat = _bf16(rng.randn(cap, cin).astype(np.float32))
    return t, tfeat[order.long()].contiguous()


@pytest.mark.parametrize("bb,cin", [(2, 6), (2, 32), (3, 16)])
def test_block_fill_plain_matches_pallas(bb, cin):
    import jax.numpy as jnp

    from pointcept_tpu.ops.pallas.block_fill import block_fill_pallas

    t, tfeat = _fill_inputs(bb, cin)
    b3 = 1 << (3 * bb)
    want = np.asarray(block_fill_pallas(jnp.asarray(tfeat.float().numpy(), jnp.bfloat16),
                                        jnp.asarray(t["rc_sorted"].numpy()),
                                        jnp.asarray(t["fill_start"].numpy()), b3), np.float32)
    m = t["fill_start"].shape[0]
    got = kernels.block_fill(tfeat, t["rc_sorted"], t["fill_start"], b3)
    assert got.shape == ((m + 1) * b3, cin)
    np.testing.assert_array_equal(got.float().numpy(), want[: (m + 1) * b3])
    assert not want[(m + 1) * b3 :].any()  # the TPU fill group's extra rows are zero
    assert np.count_nonzero(got.float().numpy().any(1)) > 0


@pytest.mark.parametrize("c", [8, 32])
def test_take_back_plain_matches_take_and_pin(c):
    import jax.numpy as jnp

    from pointcept_tpu.ops.pallas.layout_pin import pin_rowmajor

    rng = np.random.RandomState(c)
    dense, tdense = _bf16(rng.randn(4096, c).astype(np.float32))
    slot = rng.randint(0, 4096, 1000).astype(np.int32)
    want = np.asarray(pin_rowmajor(jnp.take(jnp.asarray(dense, jnp.bfloat16), jnp.asarray(slot), axis=0)),
                      np.float32)
    got = kernels.take_back_rows(tdense, torch.as_tensor(slot))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_wrappers_refuse_other_devices():
    x = torch.empty((2, 128, 96), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        kernels.patch_attention_fwd(x, 2, 0.25)
    stats = torch.empty((2, 2, 128), device="meta")
    with pytest.raises(ValueError):
        kernels.patch_attention_bwd(x, x[..., :32], x[..., :32], stats, stats, 2, 0.25)
    with pytest.raises(ValueError):
        kernels.take_back_rows(x[0], torch.empty(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        kernels.block_fill(x[0], torch.empty(128, dtype=torch.int32, device="meta"),
                           torch.empty(2, dtype=torch.int32, device="meta"), 64)


def test_tap_conv_wrappers_refuse_other_devices():
    dense = torch.empty((2 * 64, 8), dtype=torch.bfloat16, device="meta")
    nbr = torch.empty((2, 27), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.tap_conv_fwd(dense, nbr, torch.empty((27, 8, 16), device="meta"), 4, 3)
    with pytest.raises(ValueError):
        kernels.tap_conv_dw(dense, nbr, dense, 4, 3)


def _old_fwd_accepts(k, d):
    """The patch sizes the forward took before its redesign: K and a
    transposed V, rows padded by 8 elements, within 227 KB."""
    return (k * (d + 8) + d * (k + 8)) * 2 <= 227 * 1024


def _old_bwd_accepts(k, d):
    """The same for the two backward kernels of before (dq, dk/dv)."""
    dq = (2 * k * (d + 8) + d * (k + 8)) * 2
    dkv = (2 * k * (d + 8) + 2 * d * (k + 8)) * 2 + 3 * k * 4
    return max(dq, dkv) <= 227 * 1024


@pytest.mark.parametrize("d", [16, 32])
def test_attention_forward_takes_every_old_patch_size(d):
    from pointcept_tpu_torch.ops.kernels.patch_attention import SMEM_LIMIT, fwd_shared_memory

    old = [k for k in range(16, 4096, 16) if _old_fwd_accepts(k, d)]
    assert old and all(fwd_shared_memory(k, d) <= SMEM_LIMIT for k in old)


@pytest.mark.parametrize("d", [16, 32])
def test_attention_backward_plans_every_old_patch_size(d):
    """Every (K, D) the old backward took plans a cluster of at most 8
    blocks within 227 KB, with blocks that cover the keys exactly: W warps
    of T key tiles of 16, at most one query tile a warp a step, no empty
    block."""
    from pointcept_tpu_torch.ops.kernels.patch_attention import SMEM_LIMIT, bwd_plan

    old = [k for k in range(16, 4096, 16) if _old_bwd_accepts(k, d)]
    assert old
    for k in old:
        s, w, t, smem = bwd_plan(k, d)
        assert smem <= SMEM_LIMIT and 1 <= s <= 8, (k, s, smem)
        assert 1 <= w <= (16 if d == 16 else 8) and w <= -(-k // 64), (k, w)
        assert t in ((1, 4) if d == 16 else (1,)) and k % (16 * t) == 0 and (t == 1 or w <= 8), (k, t, w)
        assert (s - 1) * w * 16 * t < k <= s * w * 16 * t, (k, s, w, t)


# (path, stage, pairs = patches x heads) of PTv3-base's attention calls at
# K 1024, D 16: the eval forward (one 102,400-point scene) and the train
# step (two), encoder and decoder widths (chip_smoke.attention_shapes)
MAIN_PATH_PAIRS = [("eval", 0, 202), ("eval", 0, 404), ("eval", 1, 144), ("eval", 2, 80),
                   ("eval", 3, 64), ("eval", 4, 64), ("train", 0, 404), ("train", 0, 808),
                   ("train", 1, 288), ("train", 2, 160), ("train", 3, 112), ("train", 4, 128)]


@pytest.mark.parametrize("path,stage,pairs", MAIN_PATH_PAIRS)
def test_attention_plans_fill_the_card_on_the_main_paths(path, stage, pairs):
    """At every main-path shape both kernels fit in shared memory and put at
    least 132 blocks (the H100's SMs) in flight: the forward at least one
    per 256 query rows of a (patch, head); in the train step the backward
    too, S per (patch, head), its warps owning four key tiles each."""
    from pointcept_tpu_torch.ops.kernels.patch_attention import SMEM_LIMIT, bwd_plan, fwd_shared_memory

    k, d = 1024, 16
    assert fwd_shared_memory(k, d) <= SMEM_LIMIT and pairs * (k // 256) >= 132
    s, _, t, smem = bwd_plan(k, d)
    assert smem <= SMEM_LIMIT and t == 4
    assert path == "eval" or pairs * s >= 132  # the eval forward runs no backward


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# (nP, K, C, H) on the card: K 1024 at the five PTv3-base widths (head dim
# 16), fewer (patch, head) pairs than the card's 132 SMs, one patch, a patch
# size that is not a multiple of 64, the whole-K kernels' patch 128, head
# dim 32 (the backward takes K <= 768 there)
ATTN_CARD_CASES = [(4, 1024, 32, 2), (4, 1024, 64, 4), (4, 1024, 128, 8), (4, 1024, 256, 16),
                   (4, 1024, 512, 32), (2, 1024, 512, 32), (1, 1024, 32, 2), (3, 48, 32, 2),
                   (3, 128, 64, 4), (2, 1024, 64, 2), (2, 768, 64, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("np_,k,c,h", ATTN_CARD_CASES)
def test_attention_kernel_matches_plain_on_card(cuda, np_, k, c, h):
    g = torch.Generator(device=cuda).manual_seed(c + k)
    qkv = torch.randn((np_, k, 3 * c), generator=g, device=cuda).to(torch.bfloat16)
    n0 = kernels.patch_attention_fwd.launches
    got = kernels.patch_attention_fwd(qkv, h, (c // h) ** -0.5)
    assert kernels.patch_attention_fwd.launches == n0 + 1
    want = kernels.patch_attention_fwd_plain(qkv, h, (c // h) ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("np_,k,c,h", [cs for cs in ATTN_CARD_CASES if cs[2] // cs[3] == 16 or cs[1] <= 768])
def test_attention_backward_kernel_matches_plain_on_card(cuda, np_, k, c, h):
    """The forward with and without statistics gives the same bits, the
    backward matches its plain version and gives the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(c + k)
    qkv = torch.randn((np_, k, 3 * c), generator=g, device=cuda).to(torch.bfloat16)
    dout = torch.randn((np_, k, c), generator=g, device=cuda).to(torch.bfloat16)
    scale = (c // h) ** -0.5
    out, m, l = kernels.patch_attention_fwd(qkv, h, scale, stats=True)
    assert torch.equal(out, kernels.patch_attention_fwd(qkv, h, scale))
    n0 = kernels.patch_attention_bwd.launches
    got = kernels.patch_attention_bwd(qkv, out, dout, m, l, h, scale)
    assert kernels.patch_attention_bwd.launches == n0 + 1
    want = kernels.patch_attention_bwd_plain(qkv, out, dout, m, l, h, scale)
    # bf16 outputs (one ulp 2^-8), p and dS rounded to bf16 at slightly
    # different points of exp and summation order
    scale_ = want.float().abs().max()
    assert ((got.float() - want.float()).abs() <= 2e-2 * scale_ + 2e-2 * want.float().abs()).all()
    assert torch.equal(got, kernels.patch_attention_bwd(qkv, out, dout, m, l, h, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [6, 32, 64, 128, 256])
@pytest.mark.parametrize("identity", [True, False])
def test_fill_and_take_back_backward_match_plain_on_card(cuda, c, identity):
    """`BlockFill` and `TakeBack` backward passes on the card (the take-back
    and fill kernels) against the same functions on the CPU (plain
    versions): exactly equal."""
    from pointcept_tpu_torch.ops.block_conv import BlockFill, TakeBack

    t, _ = _fill_inputs(2, c)
    n = t["slot"].shape[0]
    if not identity:
        t = dict(t, identity_order0=False)
    g = torch.Generator().manual_seed(c)
    feat = torch.randn((n, c), generator=g).to(torch.bfloat16)
    b3 = 64
    rows = (t["nbr"].shape[0] + 1) * b3
    g_dense = torch.randn((rows, c), generator=g).to(torch.bfloat16)
    g_rows = torch.randn((n, c), generator=g).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", cuda):
        td = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in t.items()}
        f = feat.to(dev).requires_grad_()
        (gf,) = torch.autograd.grad(BlockFill.apply(f, td, torch.bfloat16), f, g_dense.to(dev))
        d = torch.zeros((rows, c), dtype=torch.bfloat16, device=dev, requires_grad=True)
        (gd,) = torch.autograd.grad(TakeBack.apply(d, td), d, g_rows.to(dev))
        out[str(dev)] = (gf.cpu(), gd.cpu())
    assert torch.equal(out["cpu"][0], out[str(cuda)][0])
    assert torch.equal(out["cpu"][1], out[str(cuda)][1])


@pytest.mark.gpu
@pytest.mark.parametrize("bb,cin", [(2, 6), (2, 32), (2, 128), (3, 16)])
def test_block_fill_kernel_matches_plain_on_card(cuda, bb, cin):
    t, tfeat = _fill_inputs(bb, cin)
    rc, starts, f = t["rc_sorted"].to(cuda), t["fill_start"].to(cuda), tfeat.to(cuda)
    b3 = 1 << (3 * bb)
    assert torch.equal(kernels.block_fill(f, rc, starts, b3), kernels.block_fill_plain(f, rc, starts, b3))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [6, 32, 64, 128])
def test_take_back_kernel_matches_plain_on_card(cuda, c):
    g = torch.Generator(device=cuda).manual_seed(c)
    dense = torch.randn((8192, c), generator=g, device=cuda).to(torch.bfloat16)
    slot = torch.randint(0, 8192, (5000,), generator=g, device=cuda, dtype=torch.int32)
    assert torch.equal(kernels.take_back_rows(dense, slot), kernels.take_back_rows_plain(dense, slot))


def _tap_inputs(bb, cin, cout, k, seed=0):
    """Dense tiles of a scene (the fill of bf16 features), the table with
    its zero-tile row, a bf16 weight and a cotangent filled the same way, so
    that both are zero outside the occupied tiles as on the model's path."""
    t, tfeat = _fill_inputs(bb, cin, seed, m=1024)
    b3 = 1 << (3 * bb)
    rc, starts = t["rc_sorted"], t["fill_start"]
    dense = kernels.block_fill_plain(tfeat, rc, starts, b3)
    nbr = t["nbr"]
    m = nbr.shape[0]
    nbr_ext = torch.cat([nbr, torch.full((1, 27), m, dtype=nbr.dtype)]).contiguous()
    g = torch.Generator().manual_seed(seed + 1)
    w = (torch.randn((k**3, cin, cout), generator=g) * (k**3 * cin) ** -0.5).to(torch.bfloat16)
    cot = torch.randn((tfeat.shape[0], cout), generator=g).to(torch.bfloat16)
    gout = kernels.block_fill_plain(cot, rc, starts, b3)
    return dense, nbr_ext, w, gout


# (block bits, k, Cin, Cout): PTv3's 4^3 blocks (stage 0 and its stem),
# SpUNet's 8^3 blocks (stem, level 0 decoder, level 3 decoder), odd widths
TAP_CASES = [(2, 3, 32, 32), (2, 5, 6, 32), (3, 5, 6, 32), (3, 3, 128, 96), (3, 3, 384, 256),
             (3, 3, 96, 96), (2, 3, 8, 20), (3, 5, 64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("bb,k,cin,cout", TAP_CASES)
def test_tap_conv_kernels_match_plain_on_card(cuda, bb, k, cin, cout):
    """`tap_conv_fwd` (forward, and the input gradient with the flipped,
    transposed weight) within 1e-2 of the largest value + 8e-3 relative
    (bf16 output, f32 sums in another order); `tap_conv_dw` within 1e-3
    relative L2 and bit-identical across two runs."""
    b = 1 << bb
    dense, nbr_ext, w, gout = (x.to(cuda) for x in _tap_inputs(bb, cin, cout, k))
    n0 = kernels.tap_conv_fwd.launches
    for x, wt in ((dense, w), (gout, w.flip(0).transpose(1, 2).contiguous())):
        got = kernels.tap_conv_fwd(x, nbr_ext, wt, b, k).float()
        want = kernels.tap_conv_fwd_plain(x, nbr_ext, wt, b, k).float()
        assert float(want.abs().max()) > 0
        assert ((got - want).abs() <= 1e-2 * want.abs().max() + 8e-3 * want.abs()).all()
    assert kernels.tap_conv_fwd.launches == n0 + 2
    got = kernels.tap_conv_dw(dense, nbr_ext, gout, b, k)
    want = kernels.tap_conv_dw_plain(dense, nbr_ext, gout, b, k)
    assert got.shape == (k**3, cin, cout) and got.dtype == torch.float32
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) < 1e-3
    assert torch.equal(got, kernels.tap_conv_dw(dense, nbr_ext, gout, b, k))


@pytest.mark.gpu
def test_tap_conv_kernels_refuse_unsupported_shapes(cuda):
    """Block sizes other than 4 and 8, kernel sizes other than 3 and 5,
    float32 tiles and more than 512 channels raise instead of launching."""
    dense, nbr_ext, w, _ = (x.to(cuda) for x in _tap_inputs(2, 8, 16, 3))
    for args in ((dense, nbr_ext, w, 2, 3), (dense, nbr_ext, w, 4, 7), (dense.float(), nbr_ext, w, 4, 3),
                 (dense, nbr_ext, torch.zeros((27, 8, 640), device=cuda), 4, 3)):
        with pytest.raises((ValueError, TypeError)):
            kernels.tap_conv_fwd(*args)


@pytest.mark.gpu
def test_gather_conv_vjp_is_bit_identical_on_card(cuda):
    """The pulled VJP of the gather conv (`NeighborGather`) gives the same
    bits on every run, where the atomics of `TakeRows` did not."""
    from pointcept_tpu_torch.ops.sparse_conv import build_subm_neighbor_map, gather_conv

    rng = np.random.RandomState(0)
    depth, cap = 8, 1536
    grid = torch.as_tensor(np.unique(rng.randint(0, 14, (cap, 3)), axis=0).astype(np.int32))
    n = grid.shape[0]
    mask = torch.ones(n, dtype=torch.bool)
    nbr = build_subm_neighbor_map(grid.to(cuda), torch.zeros(n, dtype=torch.int32, device=cuda),
                                  mask.to(cuda), depth, 3)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, 64), generator=g, device=cuda).requires_grad_()
    w = torch.randn((27, 64, 64), generator=g, device=cuda).requires_grad_()
    cot = torch.randn((n, 64), generator=g, device=cuda)
    runs = [torch.autograd.grad(gather_conv(x, nbr, w, compute_dtype=torch.bfloat16), (x, w), cot)
            for _ in range(3)]
    assert int((nbr >= 0).sum()) > 4 * n  # rows read by several neighbours
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
