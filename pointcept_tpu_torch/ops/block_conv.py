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

Unoccupied voxels hold zeros, so submanifold semantics are exact. Every
array is of static size: ``block_capacity`` bounds the occupied blocks, and
points of blocks beyond it get zero output and are counted in ``overflow``.
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
    jpos = lex_lookup(block_keys, q, bdepth).reshape(26, m)
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


def _halo_expand(dense: torch.Tensor, nbr: torch.Tensor, halo: int) -> torch.Tensor:
    """[R, B, B, B, C] (trailing rows all-zero) -> [R, B+2h, B+2h, B+2h, C].

    Exact 27-region assembly: each region is a slice of the neighbour block
    at that offset, read through its ``nbr`` column, so diagonal neighbours
    count even where face neighbours are empty."""
    if halo == 0:
        return dense
    bsz = dense.shape[1]
    pieces_x = []
    for a in (-1, 0, 1):
        x0, x1 = _slab(a, bsz, halo)
        pieces_y = []
        for b in (-1, 0, 1):
            y0, y1 = _slab(b, bsz, halo)
            pieces_z = []
            for c in (-1, 0, 1):
                z0, z1 = _slab(c, bsz, halo)
                if (a, b, c) == (0, 0, 0):
                    pieces_z.append(dense)
                    continue
                k = OFFS27.index((a, b, c))
                pieces_z.append(dense[nbr[:, k].long(), x0:x1, y0:y1, z0:z1, :])
            pieces_y.append(torch.cat(pieces_z, dim=3))
        pieces_x.append(torch.cat(pieces_y, dim=2))
    return torch.cat(pieces_x, dim=1)


def block_subm_conv(
    feat: torch.Tensor,  # [N, Cin]
    tables: dict,
    weight: torch.Tensor,  # [k^3, Cin, Cout] (kernel_offsets C-order)
    bias: Optional[torch.Tensor] = None,
    kernel_size: int = 3,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Submanifold sparse conv via dense blocks; equal to `gather_conv` over
    the same inputs up to rounding in `compute_dtype`.

    The dense tiles and the conv output are held in `compute_dtype`; the conv
    accumulates in float32 (cuDNN on the GPU; an f32 conv of the rounded
    operands on the CPU)."""
    bb = tables["block_bits"]
    nbr = tables["nbr"]
    nb = nbr.shape[0]
    bsz = 1 << bb
    b3 = bsz**3
    halo = (kernel_size - 1) // 2
    assert halo <= bsz, "kernel halo exceeds block size"
    cin = feat.shape[1]
    cout = weight.shape[-1]

    f = feat.to(compute_dtype)
    if not tables["identity_order0"]:
        f = f[tables["order0"].long()]
    dense = block_fill(f.contiguous(), tables["rc_sorted"], tables["fill_start"], b3)
    nrows = nb + 1
    dense = dense.view(nrows, bsz, bsz, bsz, cin)
    # the zero tile is block nb: missing neighbours and its own halo read it
    nbr_ext = torch.cat([nbr, torch.full((1, nbr.shape[1]), nb, dtype=nbr.dtype, device=nbr.device)])
    hal = _halo_expand(dense, nbr_ext, halo)  # [R, H, H, H, Cin]
    w = weight.reshape(kernel_size, kernel_size, kernel_size, cin, cout).permute(4, 3, 0, 1, 2)
    x = hal.permute(0, 4, 1, 2, 3)  # NCDHW view of the NDHWC tiles
    if feat.device.type == "cpu":
        out = F.conv3d(x.float(), w.to(compute_dtype).float()).to(compute_dtype)
    else:
        out = F.conv3d(x, w.to(compute_dtype))
    out = out.permute(0, 2, 3, 4, 1).reshape(nrows * b3, cout).contiguous()
    res = take_back_rows(out, tables["slot"])
    res = res.to(feat.dtype)
    if bias is not None:
        res = res + bias
    return res


def default_block_capacity(capacity: int, factor: float = 1.0 / 16.0, multiple: int = 128) -> int:
    """Static bound on occupied blocks (overflow blocks output zeros)."""
    m = max(int(np.ceil(capacity * factor)), multiple)
    return ((m + multiple - 1) // multiple) * multiple
