"""Submanifold sparse conv as gather-GEMM (counterpart of
`pointcept_tpu/ops/sparse_conv.py`, the gather engine).

Active voxels are looked up by their folded Morton key: the table of all
rows' keys is sorted once, and every kernel offset's neighbour keys are found
with one `torch.searchsorted`. The result is the rule map ``nbr [N, k^3]``
(-1 = missing), shared by every conv of a stage. The conv gathers each
site's k^3 neighbour rows and runs one matmul.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from . import serialization as ser
from .segment_ops import TakeRows

# Batch id used for *queries* from padding points: never matches any stored key
# (stored padding uses BATCH_SENTINEL).
QUERY_VOID = ser.BATCH_SENTINEL + 1


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """[k^3, 3] integer offsets, C-order over (d0, d1, d2), centered (the
    enumeration order of a [k, k, k] conv weight)."""
    r = np.arange(kernel_size) - (kernel_size - 1) // 2
    return np.array(list(itertools.product(r, r, r)), dtype=np.int32)


def lex_lookup(table_keys: torch.Tensor, query_keys: torch.Tensor, depth: int) -> torch.Tensor:
    """Positions of query key triples [M, 3] in lexicographically sorted table
    triples [T, 3]; -1 where absent. Keys the query side can match are unique
    in the table (only padding rows repeat, and no query carries their batch)."""
    t = ser.fold_keys(table_keys, depth)
    q = ser.fold_keys(query_keys, depth)
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
    table = ser.fold_keys(keys, depth)
    table, point_idx = torch.sort(table, stable=True)
    r = torch.arange(kernel_size, dtype=torch.int32, device=dev) - (kernel_size - 1) // 2
    offs = torch.cartesian_prod(r, r, r)  # kernel_offsets, computed on the card
    qg = grid_coord[None, :, :] + offs[:, None, :]  # [k^3, N, 3]
    in_range = ((qg >= 0) & (qg <= lim)).all(dim=-1) & mask[None, :]
    qb = torch.where(in_range, key_batch[None, :].to(torch.int32), QUERY_VOID)
    q = ser.fold_keys(
        ser.encode(torch.clamp(qg, 0, lim).reshape(-1, 3), qb.reshape(-1), depth, "z"), depth
    )
    pos = torch.searchsorted(table, q)
    safe = torch.clamp(pos, max=n - 1)
    hit = (pos < n) & (table[safe] == q)
    nbr = torch.where(hit, point_idx[safe], -1).to(torch.int32).reshape(len(offs), n)
    nbr[len(offs) // 2] = torch.where(mask, torch.arange(n, dtype=torch.int32, device=dev), -1)
    return nbr.T.contiguous()


def gather_conv(
    feat: torch.Tensor,  # [N, Cin]
    nbr: torch.Tensor,  # [N, K]
    weight: torch.Tensor,  # [K, Cin, Cout]
    bias: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """out[i] = sum_k feat[nbr[i,k]] @ weight[k] (missing neighbours add 0).

    With `compute_dtype`, operands are rounded to it and the product is
    accumulated in float32 (the JAX package's bf16 gather + f32-accumulated
    dot). The f32 result is cast to feat's dtype, then the bias is added."""
    n, k = nbr.shape
    cin = feat.shape[1]
    cout = weight.shape[2]
    f = feat if compute_dtype is None else feat.to(compute_dtype)
    w = weight if compute_dtype is None else weight.to(compute_dtype)
    idx = torch.clamp(nbr.long(), min=0)
    g = TakeRows.apply(f, idx.reshape(-1)).reshape(n, k, cin)
    g = torch.where((nbr >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    out = g.reshape(n, k * cin).float() @ w.reshape(k * cin, cout).float()
    out = out.to(feat.dtype)
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
