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


def _fill_inputs(bb, cin, seed=0):
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
    t = build_block_tables(keys, order, torch.as_tensor(grid), mask, depth, 256, bb)
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
    with pytest.raises(ValueError):
        kernels.take_back_rows(x[0], torch.empty(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        kernels.block_fill(x[0], torch.empty(128, dtype=torch.int32, device="meta"),
                           torch.empty(2, dtype=torch.int32, device="meta"), 64)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("c,h", [(32, 2), (64, 4), (128, 8), (256, 16), (512, 32)])
def test_attention_kernel_matches_plain_on_card(cuda, c, h):
    g = torch.Generator(device=cuda).manual_seed(c)
    qkv = torch.randn((4, 1024, 3 * c), generator=g, device=cuda).to(torch.bfloat16)
    n0 = kernels.patch_attention_fwd.launches
    got = kernels.patch_attention_fwd(qkv, h, (c // h) ** -0.5)
    assert kernels.patch_attention_fwd.launches == n0 + 1
    want = kernels.patch_attention_fwd_plain(qkv, h, (c // h) ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


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
