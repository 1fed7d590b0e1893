"""Submanifold sparse conv as gather-GEMM (counterpart of
`pointcept_tpu/ops/sparse_conv.py`, the gather engine).

Active voxels are looked up by their folded Morton key: the table of all
rows' keys is sorted once, and every kernel offset's neighbour keys are found
with one `torch.searchsorted`. The result is the rule map ``nbr [N, k^3]``
(-1 = missing), shared by every conv of a stage. The conv gathers each
site's k^3 neighbour rows and runs one matmul. The strided (k2 s2) and
inverse convs of SpUNet read parent/child tables built once per striding.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from . import serialization as ser
from .segment_ops import TakeRowsOnce

# Batch id used for *queries* from padding points: never matches any stored key
# (stored padding uses BATCH_SENTINEL).
QUERY_VOID = ser.BATCH_SENTINEL + 1


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """[k^3, 3] integer offsets, C-order over (d0, d1, d2), centered (the
    enumeration order of a [k, k, k] conv weight)."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    return np.array(list(itertools.product(r, r, r)), dtype=np.int32)


def lex_lookup(table_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """Positions of query key triples [M, 3] in lexicographically sorted table
    triples [T, 3]; -1 where absent. Keys the query side can match are unique
    in the table (only padding rows repeat, and no query carries their batch)."""
    t = ser.fold_keys(table_keys)
    q = ser.fold_keys(query_keys)
    pos = torch.searchsorted(t, q)
    safe = torch.clamp(pos, max=t.shape[0] - 1)
    hit = (pos < t.shape[0]) & (t[safe] == q)
    return torch.where(hit, pos, -1).to(torch.int32)


def build_subm_neighbor_map(
    grid_coord: torch.Tensor,
    key_batch: torch.Tensor,
    mask: torch.Tensor,
    depth: int,
    kernel_size: int,
) -> torch.Tensor:
    """nbr [N, k^3] int32: per active site, the input site at each kernel
    offset (-1 = none); the spconv SubM rule map."""
    n = grid_coord.shape[0]
    dev = grid_coord.device
    lim = (1 << depth) - 1
    keys = ser.encode(torch.clamp(grid_coord, 0, lim), key_batch, depth, "z")
    table = ser.fold_keys(keys)
    table, point_idx = torch.sort(table, stable=True)
    r = torch.arange(kernel_size, dtype=torch.int32, device=dev) - (kernel_size - 1) // 2
    offs = torch.cartesian_prod(r, r, r)  # kernel_offsets, computed on the card
    qg = grid_coord[None, :, :] + offs[:, None, :]  # [k^3, N, 3]
    in_range = ((qg >= 0) & (qg <= lim)).all(dim=-1) & mask[None, :]
    qb = torch.where(in_range, key_batch[None, :].to(torch.int32), QUERY_VOID)
    q = ser.fold_keys(ser.encode(torch.clamp(qg, 0, lim).reshape(-1, 3), qb.reshape(-1), depth, "z"))
    pos = torch.searchsorted(table, q)
    safe = torch.clamp(pos, max=n - 1)
    hit = (pos < n) & (table[safe] == q)
    nbr = torch.where(hit, point_idx[safe], -1).to(torch.int32).reshape(len(offs), n)
    nbr[len(offs) // 2] = torch.where(mask, torch.arange(n, dtype=torch.int32, device=dev), -1)
    return nbr.T.contiguous()


class NeighborGather(torch.autograd.Function):
    """``x[nbr]`` with zero rows where ``nbr < 0``: [N, Cin], nbr [N, K] ->
    [N, K, Cin], for a submanifold rule map.

    The VJP pulls instead of adding: point j reads point i at offset k
    exactly when i reads j at the opposite offset K - 1 - k (the offsets are
    centro-symmetric, the lookups exact; padding rows read nothing and are
    read by nothing), so ``dx[j] = sum_k dG[nbr[j, K-1-k], k]``, a gather
    and a sum in a fixed order, f32, rounded once to x's dtype. No atomics,
    which would add the many reads of each point in the order they come:
    the gradient is the same on every run."""

    @staticmethod
    def gather(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        n, k = nbr.shape
        g = x[torch.clamp(nbr, min=0).reshape(-1).long()].reshape(n, k, x.shape[1])
        return torch.where((nbr >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))

    @staticmethod
    def pull(g: torch.Tensor, nbr: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, k = nbr.shape
        opp = nbr.flip(1)  # opp[j, k] = nbr[j, K-1-k]: the reader of j at offset k
        src = torch.clamp(opp, min=0).long() * k + torch.arange(k, device=nbr.device)
        pulled = g.reshape(n * k, -1)[src.reshape(-1)].reshape(n, k, -1)
        pulled = torch.where((opp >= 0)[..., None], pulled,
                             torch.zeros((), dtype=g.dtype, device=g.device))
        return pulled.sum(dim=1, dtype=torch.float32).to(dtype)

    @staticmethod
    def forward(ctx, x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(nbr)
        ctx.dtype = x.dtype
        return NeighborGather.gather(x, nbr)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (nbr,) = ctx.saved_tensors
        return NeighborGather.pull(g, nbr, ctx.dtype), None


class GatherGEMM(torch.autograd.Function):
    """``gather(x, nbr).reshape(N, K * Cin) @ w.reshape(K * Cin, Cout)`` in
    f32 (operands cast up, result f32), saving x, nbr and w rather than the
    gathered rows, which are K times x and f32: the backward gathers them
    again. The gradients are the unfused ops' under autograd, bit for bit
    (the matmul's two products, each cast back to its operand's dtype; the
    rows' VJP a pull, `NeighborGather`, for a submanifold rule map, or
    `TakeRowsOnce`' adds for a table that reads each row at most once)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor, symmetric: bool) -> torch.Tensor:
        ctx.save_for_backward(x, nbr, w)
        ctx.symmetric = symmetric
        g = NeighborGather.gather(x, nbr)
        return g.reshape(nbr.shape[0], -1).float() @ w.reshape(-1, w.shape[2]).float()

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        x, nbr, w = ctx.saved_tensors
        n, k = nbr.shape
        dx = dw = None
        if ctx.needs_input_grad[2]:
            g = NeighborGather.gather(x, nbr).reshape(n, -1).float()
            dw = (g.T @ dout).to(w.dtype).reshape(w.shape)
            del g
        if ctx.needs_input_grad[0]:
            dg = (dout @ w.reshape(-1, w.shape[2]).float().T).to(x.dtype).reshape(n, k, -1)
            if ctx.symmetric:
                dx = NeighborGather.pull(dg, nbr, x.dtype)
            else:
                dg = torch.where((nbr >= 0)[..., None], dg, torch.zeros((), dtype=dg.dtype, device=dg.device))
                idx = torch.clamp(nbr.long(), min=0).reshape(-1)
                dx = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device).index_add_(
                    0, idx, dg.reshape(n * k, -1).float()).to(x.dtype)
        return dx, None, dw, None


def gather_conv(
    feat: torch.Tensor,  # [N, Cin]
    nbr: torch.Tensor,  # [N, K]
    weight: torch.Tensor,  # [K, Cin, Cout]
    bias: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    symmetric: bool = True,
) -> torch.Tensor:
    """out[i] = sum_k feat[nbr[i,k]] @ weight[k] (missing neighbours add 0).

    With `compute_dtype`, operands are rounded to it and the product is
    accumulated in float32 (the JAX package's bf16 gather + f32-accumulated
    dot). The f32 result is cast to feat's dtype, then the bias is added.

    `symmetric`: `nbr` is a submanifold rule map, and the gather's VJP pulls
    (`NeighborGather`). Otherwise (a strided conv's child table, which reads
    each row at most once) it adds the cotangents into their rows as
    `TakeRowsOnce` does: one nonzero term per row, so exact in any order. The
    backward gathers the rows again (`GatherGEMM`) rather than keep them."""
    f = feat if compute_dtype is None else feat.to(compute_dtype)
    w = weight if compute_dtype is None else weight.to(compute_dtype)
    out = GatherGEMM.apply(f, nbr, w, symmetric).to(feat.dtype)
    if bias is not None:
        out = out + bias
    return out


def build_strided_maps(
    grid_coord: torch.Tensor,  # [N, 3]
    key_batch: torch.Tensor,  # [N]
    mask: torch.Tensor,  # [N]
    depth: int,
    out_capacity: int,
) -> dict:
    """Stride-2 downsample structure (SparseConv3d k2 s2 and its inverse).

    Returns a dict with:
      out_grid   [M, 3] int32 — coarse grid of each output site
      out_batch  [M] int32 — its scene, -1 = empty
      child      [M, 8] int32 — point index of each child offset, -1 = missing
      parent_of  [N] int32 — output site of each input point (M if dropped or padding)
      child_slot [N] int32 — the point's offset within its parent, in 0..7
      overflow   [] int32 — valid points whose site fell beyond M

    The sites are the runs of equal coarse keys in sorted order; no host
    waits (heads and children land through dump-slot scatters)."""
    n = grid_coord.shape[0]
    dev = grid_coord.device
    m = out_capacity
    coarse = grid_coord >> 1
    keys = ser.encode(coarse, torch.where(mask, key_batch, ser.BATCH_SENTINEL), depth - 1, "z")
    order = ser.argsort_keys(keys, depth - 1).long()
    sk = keys[order]
    valid_sorted = mask[order]
    prev_eq = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), ser.keys_equal(sk[1:], sk[:-1])])
    head = valid_sorted & ~prev_eq
    cluster_sorted = (torch.cumsum(head.to(torch.int32), 0) - 1).to(torch.int32)
    ok = valid_sorted & (cluster_sorted < m)
    cl = torch.where(ok, cluster_sorted, m)
    parent_of = torch.empty(n, dtype=torch.int32, device=dev).scatter_(0, order, cl)
    g = grid_coord.to(torch.int32)
    child_slot = ((g[:, 0] & 1) << 2) | ((g[:, 1] & 1) << 1) | (g[:, 2] & 1)
    head_target = torch.where(head & (cluster_sorted < m), cluster_sorted, m).long()
    out_grid = torch.zeros((m + 1, 3), dtype=torch.int32, device=dev).index_copy_(
        0, head_target, coarse[order].to(torch.int32))[:m]
    out_batch = torch.full((m + 1,), -1, dtype=torch.int32, device=dev).index_copy_(
        0, head_target, torch.where(valid_sorted, key_batch[order].to(torch.int32), -1))[:m]
    flat = torch.where(parent_of < m, parent_of * 8 + child_slot, m * 8).long()
    pid = torch.where(mask, torch.arange(n, dtype=torch.int32, device=dev), -1)
    child = torch.full((m * 8 + 1,), -1, dtype=torch.int32, device=dev).index_copy_(
        0, flat, pid)[: m * 8].reshape(m, 8)
    return dict(out_grid=out_grid, out_batch=out_batch, child=child, parent_of=parent_of,
                child_slot=child_slot, overflow=(valid_sorted & ~ok).sum().to(torch.int32))


def strided_conv(feat: torch.Tensor, child: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Downsampling conv k2 s2: out[c] = sum_slot feat[child[c, slot]] @ W[slot]."""
    return gather_conv(feat, child, weight, bias, symmetric=False)


def inverse_conv(feat_coarse: torch.Tensor, parent_of: torch.Tensor, child_slot: torch.Tensor,
                 weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SparseInverseConv3d k2: each fine site reads its parent through the
    weight of its child slot, out[i] = feat_coarse[parent_of[i]] @ W[child_slot[i]],
    as 8 coarse-level matmuls and one row gather. Each (parent, slot) pair
    is read by at most one valid point, so the gather's VJP (`TakeRowsOnce`)
    adds one nonzero term per row."""
    m = feat_coarse.shape[0]
    k, cin, cout = weight.shape
    assert k == 8
    per_slot = torch.einsum("mc,kcd->kmd", feat_coarse.float(), weight.float()).to(feat_coarse.dtype)
    valid = parent_of < m
    p = torch.clamp(parent_of, max=m - 1).long()
    out = TakeRowsOnce.apply(per_slot.reshape(8 * m, cout), child_slot.long() * m + p)
    out = torch.where(valid[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    if bias is not None:
        out = out + bias
    return out


def k3_columns_of_k5() -> np.ndarray:
    """Columns selecting the 3^3 neighbour map out of a 5^3 map at the same
    resolution: nbr3 = nbr5[:, these]."""
    offs5 = kernel_offsets(5)
    offs3 = kernel_offsets(3)
    lut = {tuple(o): i for i, o in enumerate(offs5.tolist())}
    return np.asarray([lut[tuple(o)] for o in offs3.tolist()], np.int32)
