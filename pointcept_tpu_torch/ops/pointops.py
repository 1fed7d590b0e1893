"""Point queries (counterpart of `pointcept_tpu/ops/pointops.py`).

`knn_query`: the k nearest base points of each query within its scene, in
plain PyTorch (the JAX package's is a tiled scan, not a Pallas kernel).
`fps_numpy`: farthest point sampling on the host, for dataset loading.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

BIG = 1e10


def knn_query(k: int, base_coord: torch.Tensor, base_batch: torch.Tensor,
              query_coord: Optional[torch.Tensor] = None, query_batch: Optional[torch.Tensor] = None,
              chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest base points per query within the same scene (same batch
    id; a negative base id never matches, so padding is -1 on the base and
    -2 on the queries).

    Returns (idx [M, k] int32, dist [M, k] f32): where fewer than k exist,
    the missing neighbours repeat the first index found (index 0 when none)
    with distance sqrt(BIG). The queries go in chunks of `chunk` rows, so one
    [chunk, N] distance tile bounds the memory. Selection uses the JAX
    package's |q|^2 + |b|^2 - 2 q.b (ties to the lower index); the chosen
    neighbours' distances are then recomputed exactly, floored at 1e-12
    before the square root (its gradient at 0 is infinite)."""
    if query_coord is None:
        query_coord, query_batch = base_coord, base_batch
    m = query_coord.shape[0]
    base_ok = base_batch >= 0
    b_sq = torch.sum(base_coord**2, dim=1)[None, :]  # [1, N]
    best_d, best_i = [], []
    for s in range(0, m, chunk):
        q = query_coord[s : s + chunk]
        q_sq = torch.sum(q**2, dim=1, keepdim=True)
        d = q_sq + b_sq - 2 * (q @ base_coord.T)
        same = (query_batch[s : s + chunk, None] == base_batch[None, :]) & base_ok[None, :]
        d = torch.where(same, d, torch.full((), BIG, dtype=d.dtype, device=d.device))
        if k == 1:
            dk, ik = d.min(dim=1, keepdim=True)
        else:
            dk, ik = torch.topk(d, k, dim=1, largest=False, sorted=True)
        best_d.append(dk)
        best_i.append(ik)
    best_d, best_i = torch.cat(best_d), torch.cat(best_i)
    found = best_d < BIG
    best_i = torch.where(found, best_i, best_i[:, :1]).to(torch.int32)
    exact = torch.sum(torch.square(base_coord[best_i.long()] - query_coord[:, None, :]), dim=-1)
    exact = torch.where(found, exact, torch.full((), BIG, dtype=exact.dtype, device=exact.device))
    return best_i, torch.sqrt(torch.clamp(exact, min=1e-12))


def fps_numpy(coord: np.ndarray, num_samples: int, seed: int = 0) -> np.ndarray:
    """Farthest point sampling on the host (ModelNet's `uniform_sampling`):
    the first sample drawn from ``RandomState(seed)``, then each next the
    point farthest (squared distance) from the samples so far. Returns
    [num_samples] int64 indices. The distances are the JAX package's
    ``sum((coord - p) ** 2, axis=1)`` term for term (the three squares
    added in order, in coord's dtype), over contiguous columns: the same
    bits, several times faster."""
    n = coord.shape[0]
    rng = np.random.RandomState(seed)
    cols = [np.ascontiguousarray(coord[:, i]) for i in range(coord.shape[1])]
    selected = np.zeros(num_samples, np.int64)
    selected[0] = rng.randint(n)
    dists = np.full(n, np.inf)
    for i in range(1, num_samples):
        j = selected[i - 1]
        d = np.square(cols[0] - cols[0][j])
        for c in cols[1:]:
            d += np.square(c - c[j])
        dists = np.minimum(dists, d)
        selected[i] = np.argmax(dists)
    return selected
