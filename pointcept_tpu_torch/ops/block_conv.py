"""Block-dense submanifold convolution (counterpart of
`pointcept_tpu/ops/block_conv.py`).

The z-order serialization groups points into 2^b-sized cubic blocks whose
members are contiguous in the sorted order. A conv then runs as:

1. fill: z-sorted point rows -> raster dense tiles ``[(m+1)*b^3, Cin]`` of
   the occupied blocks plus one trailing all-zero tile (kernel `block_fill`);
2. halo: each tile grows by the kernel radius from its 26 neighbour tiles,
   read through the ``nbr`` table (a missing neighbour reads the zero tile);
3. one dense `conv3d` over all halo tiles;
4. take-back: each point reads its output row at ``slot`` (kernel
   `take_back_rows`).

With ``fused=True`` (the JAX package's ``BLOCK_CONV_FUSED=1``) steps 2-3 are
one kernel, `tap_conv_fwd`, that reads each tile's halo straight from its
neighbours (`FusedBlockConv`); no halo tensor is materialised.

Unoccupied voxels hold zeros, so submanifold semantics are exact. Every
array is of static size: ``block_capacity`` bounds the occupied blocks, and
points of blocks beyond it get zero output and are counted in ``overflow``.

The fill and the take-back are each other's VJP (`BlockFill`, `TakeBack`),
as `_block_fill` and `_take_back` are in the JAX package; the conv's own
gradients come from `ConvValid` (cuDNN on the card) or, fused, from
`FusedBlockConv` (`tap_conv_fwd` and `tap_conv_dw`). Padding and overflow
points, whose slot is the zero tile, get zero gradient.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import serialization as ser
from .kernels.block_fill import block_fill
from .kernels.take_back import take_back_rows
from .kernels.tap_conv import tap_conv_dw, tap_conv_fwd
from .sparse_conv import lex_lookup

# neighbour offsets in C-order over (dx, dy, dz) in {-1,0,1}^3 (center included)
OFFS27 = list(itertools.product((-1, 0, 1), repeat=3))
CENTER27 = OFFS27.index((0, 0, 0))


def build_block_tables(
    keys0: torch.Tensor,  # [N, 3] key triples of order 0
    order0: torch.Tensor,  # [N] argsort of keys0
    grid_coord: torch.Tensor,  # [N, 3]
    mask: torch.Tensor,  # [N] valid points
    depth: int,
    block_capacity: int,
    block_bits: int = 3,
    inverse0: Optional[torch.Tensor] = None,
    curve_is_z: bool = True,
    identity_order0: bool = False,
) -> dict:
    """Block structure from the existing serialization.

    Returns a dict with:
      slot        [N] int32 — raster dense row of each point; m*b^3 (the zero
                  tile) for padding/overflow
      order0/inverse0 [N] int32 — the z-sort permutation and its inverse
      nbr         [m, 27] int32 — neighbour block ranks in OFFS27 order,
                  m = missing (center column = self)
      block_grid  [m, 3] int32 — coarse grid of each block
      fill_start  [m] int32 — first sorted row of each block's members
      rc_sorted   [N] int32 — rank*b^3 + raster_local of each sorted point,
                  -1 for padding/overflow
      overflow    [] int32 — valid points whose block fell beyond m
    """
    dev = keys0.device
    n = keys0.shape[0]
    bb = block_bits
    b3 = 1 << (3 * bb)
    m = block_capacity
    if not curve_is_z:
        # the fill layout needs plain Morton locals: re-sort by the z curve
        keys0 = ser.encode(grid_coord, keys0[:, 0], depth, "z")
        order0 = ser.argsort_keys(keys0, depth)
        inverse0 = ser.invert_order(order0)
        identity_order0 = False
    if inverse0 is None:
        inverse0 = ser.invert_order(order0)
    o0 = order0.long()

    shifted = ser.key_shift_right(keys0, 3 * bb)
    if identity_order0:
        sk, valid_sorted = shifted, mask
        mlocal_sorted = keys0[:, 2] & (b3 - 1)
    else:
        sk, valid_sorted = shifted[o0], mask[o0]
        mlocal_sorted = keys0[o0, 2] & (b3 - 1)
    prev_eq = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), ser.keys_equal(sk[1:], sk[:-1])])
    head = valid_sorted & ~prev_eq
    rank_sorted = (torch.cumsum(head.to(torch.int32), 0) - 1).to(torch.int32)
    rank_ok = valid_sorted & (rank_sorted < m)
    rank_of_sorted = torch.where(rank_ok, rank_sorted, m)
    rank_of_point = rank_of_sorted if identity_order0 else rank_of_sorted[inverse0.long()]

    # each block's head position: ranks are dense (0..nblocks-1 in sorted
    # order), non-heads scatter into a dump slot. Nothing here waits for the
    # card (no boolean-mask indexing, no host-to-device copies), so the host
    # keeps enqueueing ahead of it.
    is_head = head & rank_ok
    tgt = torch.where(is_head, rank_sorted, m).long()
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    hsel = torch.zeros(m + 1, dtype=torch.int32, device=dev).scatter_(0, tgt, pos)[:m]
    block_valid = torch.arange(m, device=dev) < is_head.sum()
    head_point = hsel if identity_order0 else order0[hsel.long()]
    block_grid = torch.where(block_valid[:, None], grid_coord[head_point.long()] >> bb, 0)
    sentinel = torch.zeros(3, dtype=torch.int32, device=dev)
    sentinel[0] = ser.BATCH_SENTINEL
    block_keys = torch.where(block_valid[:, None], sk[hsel.long()], sentinel)  # sorted ascending
    block_batch = torch.where(block_valid, block_keys[:, 0], -1)

    # the 26 neighbour blocks: one batched lookup over the sorted block keys
    bdepth = depth - bb
    lim = (1 << bdepth) - 1
    i27 = torch.arange(27, dtype=torch.int32, device=dev)  # OFFS27, computed on the card
    offs27 = torch.stack([i27 // 9 - 1, (i27 // 3) % 3 - 1, i27 % 3 - 1], dim=1)
    noncenter = torch.cat([offs27[:CENTER27], offs27[CENTER27 + 1 :]])
    qg = block_grid[None, :, :] + noncenter[:, None, :]  # [26, m, 3]
    in_range = ((qg >= 0) & (qg <= lim)).all(dim=-1) & block_valid[None, :]
    q = ser.encode(
        torch.clamp(qg, 0, lim).reshape(-1, 3),
        torch.where(in_range, block_batch[None, :], ser.BATCH_SENTINEL + 1).reshape(-1),
        bdepth,
        "z",
    )
    jpos = lex_lookup(block_keys, q).reshape(26, m)
    res = torch.where(jpos >= 0, jpos, m).to(torch.int32)
    self_col = torch.where(block_valid, torch.arange(m, dtype=torch.int32, device=dev), m)[None, :]
    nbr = torch.cat([res[:CENTER27], self_col, res[CENTER27:]], dim=0).T.contiguous()  # [m, 27]

    # dense slot: raster offset within the block (the conv layout, not Morton)
    lmask = (1 << bb) - 1
    gx, gy, gz = grid_coord[:, 0], grid_coord[:, 1], grid_coord[:, 2]
    local = ((gx & lmask) << (2 * bb)) | ((gy & lmask) << bb) | (gz & lmask)
    slot = torch.where(rank_of_point < m, rank_of_point * b3 + local, m * b3)

    start = torch.where(block_valid, hsel, 0)
    rc_sorted = torch.where(rank_ok, rank_sorted * b3 + raster_of_morton(mlocal_sorted, bb), -1)
    return dict(
        slot=slot.to(torch.int32),
        order0=order0.to(torch.int32),
        inverse0=inverse0.to(torch.int32),
        identity_order0=identity_order0,
        block_bits=bb,
        nbr=nbr,
        block_grid=block_grid.to(torch.int32),
        fill_start=start.to(torch.int32),
        rc_sorted=rc_sorted.to(torch.int32),
        overflow=(valid_sorted & ~rank_ok).sum().to(torch.int32),
    )


class BlockFill(torch.autograd.Function):
    """feat [N, Cin] in the caller's point order -> dense tiles
    [(m+1)*b3, Cin] in `compute_dtype` (z-sorted through `order0` unless the
    batch is already in z order). VJP: the cotangent gathered at each point's
    slot by the take-back kernel, zero where the slot is the zero tile
    (`_block_fill_bwd`, pointcept_tpu/ops/block_conv.py)."""

    @staticmethod
    def forward(ctx, feat, tables, compute_dtype):
        b3 = 1 << (3 * tables["block_bits"])
        f = feat.to(compute_dtype)
        if not tables["identity_order0"]:
            f = f[tables["order0"].long()]
        ctx.slot, ctx.bound, ctx.dtype = tables["slot"], tables["nbr"].shape[0] * b3, feat.dtype
        return block_fill(f.contiguous(), tables["rc_sorted"], tables["fill_start"], b3)

    @staticmethod
    def backward(ctx, g):
        gf = take_back_rows(g.contiguous(), ctx.slot, bound=ctx.bound)
        return gf.to(ctx.dtype), None, None


class TakeBack(torch.autograd.Function):
    """Dense conv output [(m+1)*b3, C] -> per-point rows at ``slot``. VJP:
    the cotangent, put in z order through `order0`, block-filled
    (`_take_back_bwd`, pointcept_tpu/ops/block_conv.py): each valid point's
    row lands in its own slot, the zero tile and empty voxels get zero."""

    @staticmethod
    def forward(ctx, out, tables):
        ctx.tables = tables
        return take_back_rows(out, tables["slot"])

    @staticmethod
    def backward(ctx, g):
        t = ctx.tables
        if not t["identity_order0"]:
            g = g[t["order0"].long()]
        b3 = 1 << (3 * t["block_bits"])
        return block_fill(g.contiguous(), t["rc_sorted"], t["fill_start"], b3), None


def raster_of_morton(v: torch.Tensor, block_bits: int) -> torch.Tensor:
    """Raster-local offset (x-major) of Morton-local offsets `v` within one block."""
    bb = block_bits
    lx = ly = lz = torch.zeros_like(v)
    for i in range(bb):
        lx = lx | (((v >> (3 * i + 2)) & 1) << i)
        ly = ly | (((v >> (3 * i + 1)) & 1) << i)
        lz = lz | (((v >> (3 * i)) & 1) << i)
    return (lx << (2 * bb)) | (ly << bb) | lz


def _slab(a: int, bsz: int, halo: int):
    """Source range within the neighbour block at offset a for the halo tile."""
    if a == -1:
        return bsz - halo, bsz
    if a == 0:
        return 0, bsz
    return 0, halo


def _regions(bsz: int, halo: int):
    """The 26 neighbour regions of a halo tile: (OFFS27 column of the
    offset, column of the opposite offset, source slices within the
    neighbour block, destination slices within the tile)."""
    out = []
    for off in OFFS27:
        if off == (0, 0, 0):
            continue
        src = (slice(None),) + tuple(slice(*_slab(o, bsz, halo)) for o in off)
        dst = (slice(None),) + tuple(slice(0, halo) if o < 0 else slice(halo, halo + bsz) if o == 0
                                     else slice(halo + bsz, bsz + 2 * halo) for o in off)
        out.append((OFFS27.index(off), OFFS27.index(tuple(-o for o in off)), src, dst))
    return out


def _halo_expand(dense: torch.Tensor, nbr: torch.Tensor, halo: int) -> torch.Tensor:
    """[R, B, B, B, C] (trailing rows all-zero) -> [R, B+2h, B+2h, B+2h, C].

    Exact 27-region assembly: each region is a slice of the neighbour block
    at that offset, read through its ``nbr`` column, so diagonal neighbours
    count even where face neighbours are empty."""
    if halo == 0:
        return dense
    r, bsz, c = dense.shape[0], dense.shape[1], dense.shape[-1]
    hsz = bsz + 2 * halo
    out = dense.new_empty((r, hsz, hsz, hsz, c))
    mid = slice(halo, halo + bsz)
    out[:, mid, mid, mid] = dense
    for k, _, src, dst in _regions(bsz, halo):
        out[dst] = dense[(nbr[:, k].long(),) + src[1:]]
    return out


class HaloExpand(torch.autograd.Function):
    """`_halo_expand` with a VJP that pulls instead of scattering.

    Block j reads block r at offset k exactly when r reads j at the opposite
    offset (the ``nbr`` lookups are symmetric; missing and overflowed blocks
    are missing both ways). So each block's cotangent is its own tile's
    centre plus, per region, the region's cotangent gathered from the block
    at the opposite offset: gathers and adds in a fixed order, no atomics.
    The autograd VJP of the 26 gathers (`index_put_` with accumulation)
    instead serialises the thousands of duplicate reads of the zero tile.
    The zero tile's own cotangent, which nothing reads (the fill's VJP stops
    at the zero tile), is left at its centre."""

    @staticmethod
    def forward(ctx, dense: torch.Tensor, nbr: torch.Tensor, halo: int) -> torch.Tensor:
        ctx.save_for_backward(nbr)
        ctx.halo = halo
        return _halo_expand(dense, nbr, halo)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (nbr,) = ctx.saved_tensors
        h = ctx.halo
        zero_tile = g.shape[0] - 1
        bsz = g.shape[1] - 2 * h
        gd = g[:, h : h + bsz, h : h + bsz, h : h + bsz].contiguous()
        for _, opp, src, dst in _regions(bsz, h):
            j = nbr[:, opp]
            pulled = g[(j.long(),) + dst[1:]]
            gd[src] += torch.where((j < zero_tile)[:, None, None, None, None], pulled,
                                   torch.zeros((), dtype=g.dtype, device=g.device))
        return gd, None, None


class ConvValid(torch.autograd.Function):
    """`F.conv3d` without padding whose input gradient is the forward conv
    of the cotangent, padded by k - 1, with the flipped and transposed
    kernel; the weight gradient is cuDNN's. On the H100 cuDNN picks, for
    the 32-channel data gradient of the stage-0 convs, a direct kernel ~180x
    slower than its forward kernel (PERF.md); as a forward conv the same
    product takes the fast implicit-GEMM kernels."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return F.conv3d(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gp = F.pad(g, (w.shape[2] - 1,) * 6).contiguous(memory_format=torch.channels_last_3d)
            gx = F.conv3d(gp, w.flip(2, 3, 4).transpose(0, 1))
        if ctx.needs_input_grad[1]:
            gw = torch.ops.aten.convolution_backward(
                g, x, w, None, (1, 1, 1), (0, 0, 0), (1, 1, 1), False, (0, 0, 0), 1,
                (False, True, False))[1]
        return gx, gw


class FusedBlockConv(torch.autograd.Function):
    """The fused block conv and its VJP (`_fused_conv`, pointcept_tpu/ops/block_conv.py):
    dense [(m+1)*b^3, Cin] tiles in the compute dtype, nbr_ext [m+1, 27],
    weight [k^3, Cin, Cout] -> [(m+1)*b^3, Cout] in the compute dtype.

    Forward `tap_conv_fwd`. Backward: the tiles' cotangent is the same
    kernel on the output cotangent with the index-reversed, channel-
    transposed weight (correlation duality on the same neighbour table,
    which is symmetric: the zero tile's row points at itself), and the
    weight's is `tap_conv_dw`. It saves the dense tiles, not a halo."""

    @staticmethod
    def forward(ctx, dense: torch.Tensor, nbr_ext: torch.Tensor, weight: torch.Tensor,
                bsz: int, ksz: int) -> torch.Tensor:
        w = weight.to(dense.dtype)
        ctx.save_for_backward(dense, nbr_ext, w)
        ctx.geom, ctx.wdtype = (bsz, ksz), weight.dtype
        return tap_conv_fwd(dense, nbr_ext, w, bsz, ksz)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dense, nbr_ext, w = ctx.saved_tensors
        bsz, ksz = ctx.geom
        g = g.to(dense.dtype).contiguous()
        d_dense = dw = None
        if ctx.needs_input_grad[0]:
            d_dense = tap_conv_fwd(g, nbr_ext, w.flip(0).transpose(1, 2).contiguous(), bsz, ksz)
        if ctx.needs_input_grad[2]:
            dw = tap_conv_dw(dense, nbr_ext, g, bsz, ksz).to(ctx.wdtype)
        return d_dense, None, dw, None, None


def block_subm_conv(
    feat: torch.Tensor,  # [N, Cin]
    tables: dict,
    weight: torch.Tensor,  # [k^3, Cin, Cout] (kernel_offsets C-order)
    bias: Optional[torch.Tensor] = None,
    kernel_size: int = 3,
    compute_dtype: torch.dtype = torch.bfloat16,
    fused: bool = False,
) -> torch.Tensor:
    """Submanifold sparse conv via dense blocks; equal to `gather_conv` over
    the same inputs up to rounding in `compute_dtype`.

    The dense tiles and the conv output are held in `compute_dtype`; the conv
    accumulates in float32 (cuDNN on the GPU; an f32 conv of the rounded
    operands on the CPU). `fused`: the conv is `FusedBlockConv`, the
    hand-written implicit GEMM over the neighbour table (its plain version
    on the CPU)."""
    bb = tables["block_bits"]
    nbr = tables["nbr"]
    nb = nbr.shape[0]
    bsz = 1 << bb
    b3 = bsz**3
    halo = (kernel_size - 1) // 2
    assert halo <= bsz, "kernel halo exceeds block size"
    cin = feat.shape[1]
    cout = weight.shape[-1]

    dense = BlockFill.apply(feat, tables, compute_dtype)
    nrows = nb + 1
    dense = dense.view(nrows, bsz, bsz, bsz, cin)
    # the zero tile is block nb: missing neighbours and its own halo read it
    nbr_ext = torch.cat([nbr, torch.full((1, nbr.shape[1]), nb, dtype=nbr.dtype, device=nbr.device)])
    if fused:
        out = FusedBlockConv.apply(dense.view(nrows * b3, cin), nbr_ext, weight, bsz, kernel_size)
        res = TakeBack.apply(out, tables).to(feat.dtype)
        return res if bias is None else res + bias
    hal = HaloExpand.apply(dense, nbr_ext, halo) if halo else dense  # [R, H, H, H, Cin]
    w = weight.reshape(kernel_size, kernel_size, kernel_size, cin, cout).permute(4, 3, 0, 1, 2)
    x = hal.permute(0, 4, 1, 2, 3)  # NCDHW view of the NDHWC tiles
    if feat.device.type == "cpu":
        out = F.conv3d(x.float(), w.to(compute_dtype).float()).to(compute_dtype)
    else:
        out = ConvValid.apply(x, w.to(compute_dtype))
    out = out.permute(0, 2, 3, 4, 1).reshape(nrows * b3, cout).contiguous()
    res = TakeBack.apply(out, tables).to(feat.dtype)
    if bias is not None:
        res = res + bias
    return res


def default_block_capacity(capacity: int, factor: float = 1.0 / 16.0, multiple: int = 128) -> int:
    """Static bound on occupied blocks (overflow blocks output zeros)."""
    m = max(int(np.ceil(capacity * factor)), multiple)
    return ((m + multiple - 1) // multiple) * multiple
