"""Point queries (counterpart of `pointcept_tpu/ops/pointops.py`).

`knn_query`: the k nearest base points of each query within its scene, in
plain PyTorch (the JAX package's is a tiled scan, not a Pallas kernel).
`interpolation`: the inverse-distance mean of the k nearest base points'
features. `fps_numpy`: farthest point sampling on the host, for dataset
loading.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import serialization as ser
from .segment_ops import TakeRows, masked_segment_reduce

BIG = 1e10
RERANK = 8  # candidates past k that `knn_query` re-ranks by exact distance
SPATIAL_CHUNK = 256  # points a chunk of the self query's search in space
TILE = 1 << 26  # distance-tile elements the self query's search computes at once


def _chunk_columns(base_batch: torch.Tensor, query_batch: torch.Tensor, chunk: int) -> list:
    """Each query chunk's candidate columns ``(lo, hi)``: the span of base
    rows from the first to the last row of the scenes its queries hold
    (``None`` for a chunk without a valid query), in one read to the host.
    Every base row of those scenes lies in the span, so the bound is exact
    whatever the layout; where scenes are contiguous (collate concatenates
    them, pooled keys lead with the batch id) a chunk inside one scene of S
    reads 1/S of the rows."""
    n, dev = base_batch.shape[0], base_batch.device
    tops = [t.max() for t in (base_batch, query_batch) if t.numel()]
    scenes = int(torch.stack(tops).max()) + 1 if tops else 0
    if scenes == 0:
        return [None] * ((query_batch.shape[0] + chunk - 1) // chunk)
    rows = torch.arange(n, device=dev)
    ok = base_batch >= 0
    b = torch.where(ok, base_batch.long(), scenes)
    first = torch.full((scenes + 1,), n, dtype=torch.long, device=dev).scatter_reduce(0, b, rows, "amin")
    last = torch.full((scenes + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(0, b, rows, "amax")
    first[scenes], last[scenes] = n, -1  # padding rows (and queries of no scene) bound nothing
    m = query_batch.shape[0]
    pad = (-m) % chunk
    qb = torch.where((query_batch >= 0) & (query_batch < scenes), query_batch.long(), scenes)
    qb = torch.cat([qb, torch.full((pad,), scenes, dtype=torch.long, device=dev)]).view(-1, chunk)
    bounds = torch.stack([first[qb].amin(dim=1), last[qb].amax(dim=1) + 1], dim=1).tolist()
    return [(lo, hi) if hi > lo else None for lo, hi in bounds]


def _span_shortlist(base_coord: torch.Tensor, base_batch: torch.Tensor, query_coord: torch.Tensor,
                    query_batch: torch.Tensor, short: int, chunk: int):
    """The `short` nearest base candidates of every query (by the expanded
    distance), each chunk of `chunk` queries against its scenes' columns
    (`_chunk_columns`). Returns (distances, base indices) [M, short]."""
    m, n, dev = query_coord.shape[0], base_coord.shape[0], base_coord.device
    big = torch.full((), BIG, dtype=base_coord.dtype, device=dev)
    base_ok = base_batch >= 0
    b_sq = torch.sum(base_coord**2, dim=1)
    cand_d = torch.full((m, short), BIG, dtype=base_coord.dtype, device=dev)
    cand_i = torch.zeros((m, short), dtype=torch.long, device=dev)
    for c, span in enumerate(_chunk_columns(base_batch, query_batch, chunk)):
        if span is None:
            continue  # no valid query: every row keeps "none found"
        lo, hi = span
        hi = max(hi, min(lo + short, n))  # the whole shortlist where the base has it
        s = c * chunk
        q = query_coord[s : s + chunk]
        d = torch.sum(q**2, dim=1, keepdim=True) + b_sq[None, lo:hi] - 2 * (q @ base_coord[lo:hi].T)
        same = (query_batch[s : s + chunk, None] == base_batch[None, lo:hi]) & base_ok[None, lo:hi]
        dk, ik = torch.topk(torch.where(same, d, big), min(short, hi - lo), dim=1, largest=False)
        cand_d[s : s + chunk, : dk.shape[1]] = dk
        cand_i[s : s + chunk, : dk.shape[1]] = ik + lo
    return cand_d, cand_i


def _self_shortlist(k: int, coord: torch.Tensor, batch: torch.Tensor, short: int, chunk: int = SPATIAL_CHUNK):
    """The `short` nearest candidates of every point among its scene's
    points (by the expanded distance), searched in space: the points sorted
    along a z-order curve of their scene's box (16 bits an axis; a Hilbert
    curve's boxes are tighter, its transform costs ~300 launches), each point
    given an upper bound of its k-th nearest distance by the k-th nearest of
    itself and the `k` points on either side of it in that order, and each
    chunk of `chunk` sorted points searched only among the points inside its
    box widened by its largest bound (every point's k nearest lie inside it;
    a chunk with a point of no bound, in a scene of fewer than k points,
    searches its scenes whole). Chunks of like candidate counts go together in
    one batched tile of at most `TILE` elements, padded to their widest.
    Returns (distances, original indices) [N, short] in the points' own
    order. On two 65,536-point scenes a chunk searches ~4,100 points (CPU
    count), where a chunk of the scene-bounded search takes a scene."""
    n, dev = coord.shape[0], coord.device
    valid = batch >= 0
    scenes = int(batch.max()) + 1 if n else 0
    if scenes <= 0:  # no point: nothing found
        return (torch.full((n, short), BIG, dtype=coord.dtype, device=dev),
                torch.zeros((n, short), dtype=torch.long, device=dev))
    b = torch.clamp(batch, 0, scenes - 1).long()
    lo = masked_segment_reduce(coord, batch, valid, scenes, "min")
    hi = -masked_segment_reduce(-coord, batch, valid, scenes, "min")
    extent = torch.clamp((hi - lo).amax(dim=1), min=1e-6)
    grid = torch.clamp(torch.floor((coord - lo[b]) / extent[b, None] * 65535), 0, 65535).to(torch.int32)
    order = ser.argsort_keys(ser.encode(grid, torch.where(valid, batch, ser.BATCH_SENTINEL), 16, "z")).long()
    cs, bs = coord[order], batch[order]
    ok = bs >= 0
    # each point's bound: the k-th nearest of the 2k points beside it along the curve and itself
    raw = torch.arange(n, device=dev)[:, None] + torch.arange(-k, k + 1, device=dev)
    pos = torch.clamp(raw, 0, max(n - 1, 0))
    near = (raw >= 0) & (raw < n) & (bs[pos] == bs[:, None]) & ok[:, None]
    window = torch.where(near, torch.sum(torch.square(cs[pos] - cs[:, None]), dim=-1), float("inf"))
    bound = torch.kthvalue(window, k, dim=1).values
    chunks = (n + chunk - 1) // chunk
    pad = chunks * chunk - n

    def per_chunk(x, fill, reduce):
        x = torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])
        return reduce(x.view((chunks, chunk) + x.shape[1:]), dim=1)

    inf = float("inf")
    box_lo = per_chunk(torch.where(ok[:, None], cs, inf), inf, lambda x, dim: x.amin(dim=dim))
    box_hi = per_chunk(torch.where(ok[:, None], cs, -inf), -inf, lambda x, dim: x.amax(dim=dim))
    reach = per_chunk(torch.where(ok, bound, -inf), -inf, lambda x, dim: x.amax(dim=dim))
    reach = torch.sqrt(torch.clamp(reach, min=0)) * (1 + 1e-4) + 1e-6  # the window's rounding
    box_lo, box_hi = box_lo - reach[:, None], box_hi + reach[:, None]
    scene_lo = per_chunk(torch.where(ok, bs, scenes), scenes, lambda x, dim: x.amin(dim=dim))
    scene_hi = per_chunk(bs, -1, lambda x, dim: x.amax(dim=dim))
    inside = ok[None] & (bs[None] >= scene_lo[:, None]) & (bs[None] <= scene_hi[:, None])
    for axis in range(3):
        inside &= (cs[None, :, axis] >= box_lo[:, axis, None]) & (cs[None, :, axis] <= box_hi[:, axis, None])
    # each chunk's candidates in a row of one table (-1 past its count)
    counts = inside.sum(dim=1)
    pairs = inside.nonzero()
    counts_host = counts.tolist()
    table = torch.full((chunks, max(max(counts_host), 1)), -1, dtype=torch.int32, device=dev)
    slot = torch.arange(pairs.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[pairs[:, 0]]
    table[pairs[:, 0], slot] = pairs[:, 1].to(torch.int32)
    qs = torch.cat([cs, torch.zeros((pad, 3), dtype=cs.dtype, device=dev)]).view(chunks, chunk, 3)
    qb = torch.cat([bs, torch.full((pad,), -1, dtype=bs.dtype, device=dev)]).view(chunks, chunk)
    big = torch.full((), BIG, dtype=coord.dtype, device=dev)
    cand_d = torch.full((chunks, chunk, short), BIG, dtype=coord.dtype, device=dev)
    cand_i = torch.zeros((chunks, chunk, short), dtype=torch.long, device=dev)
    # chunks of like counts searched together, each tile [chunks, chunk, widest count] at most TILE elements
    by_count = sorted(range(chunks), key=counts_host.__getitem__)
    i = 0
    while i < chunks:
        j = i + 1
        while j < chunks and (j - i + 1) * chunk * counts_host[by_count[j]] <= TILE:
            j += 1
        width = counts_host[by_count[j - 1]]
        if width:
            idx = torch.as_tensor(by_count[i:j], device=dev)
            t = table[idx, :width]
            col = torch.clamp(t, min=0).long()
            c = cs[col]  # [chunks, width, 3]
            q = qs[idx]
            d = torch.sum(q**2, dim=-1, keepdim=True) + torch.sum(c**2, dim=-1)[:, None] - 2 * torch.bmm(
                q, c.transpose(1, 2))
            same = (qb[idx][:, :, None] == bs[col][:, None]) & (t >= 0)[:, None]
            dk, ik = torch.topk(torch.where(same, d, big), min(short, width), dim=2, largest=False)
            cand_d[idx, :, : dk.shape[2]] = dk
            cand_i[idx, :, : dk.shape[2]] = order[col.gather(1, ik.flatten(1)).view(ik.shape)]
        i = j
    cand_d, cand_i = cand_d.view(-1, short)[:n], cand_i.view(-1, short)[:n]
    out_d, out_i = torch.empty_like(cand_d), torch.empty_like(cand_i)
    out_d[order], out_i[order] = cand_d, cand_i
    return out_d, out_i


def knn_query(k: int, base_coord: torch.Tensor, base_batch: torch.Tensor,
              query_coord: Optional[torch.Tensor] = None, query_batch: Optional[torch.Tensor] = None,
              chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest base points per query within the same scene (same batch
    id; a negative base id never matches, so padding is -1 on the base and
    -2 on the queries).

    Returns (idx [M, k] int32, dist [M, k] f32), nearest first: where fewer
    than k exist, the missing neighbours repeat the first index found with
    distance sqrt(BIG); a query with none (a padding row, a scene without
    base points) gets index 0 and distance sqrt(BIG) in every slot, on every
    device. The queries of the base itself (no `query_coord`: PT-v2's
    blocks) are searched in space (`_self_shortlist`); other queries go in
    chunks of `chunk` rows, each against the columns of its scenes alone
    (`_chunk_columns`), so one [chunk, span] distance tile bounds the
    memory. Both give the same neighbours.

    The tile is the JAX package's |q|^2 + |b|^2 - 2 q.b, whose rounding
    (~1e-7 of |q|^2, a few 1e-3 of a 2 cm neighbour's squared distance)
    differs between devices and libraries. So it only shortlists the
    k + `RERANK` nearest candidates; their exact squared distances then pick
    the k, ties to the lower index, and give the distances (floored at
    1e-12 before the square root, whose gradient at 0 is infinite). The
    card and the CPU choose the same neighbours."""
    short = k + RERANK
    if query_coord is None:
        query_coord = base_coord
        cand_d, cand_i = _self_shortlist(k, base_coord, base_batch, short)
    else:
        cand_d, cand_i = _span_shortlist(base_coord, base_batch, query_coord, query_batch, short, chunk)
    dev = base_coord.device
    big = torch.full((), BIG, dtype=base_coord.dtype, device=dev)
    # exact squared distances of the shortlist, ranked with ties to the lower index
    cand_i, by_index = torch.sort(cand_i, dim=1, stable=True)
    found = cand_d.gather(1, by_index) < BIG
    exact = torch.sum(torch.square(base_coord[cand_i] - query_coord[:, None, :]), dim=-1)
    exact = torch.where(found, exact, torch.full((), float("inf"), dtype=exact.dtype, device=dev))
    exact, rank = torch.sort(exact, dim=1, stable=True)
    exact, best_i = exact[:, :k], cand_i.gather(1, rank[:, :k])
    found = torch.isfinite(exact)
    first = torch.where(found[:, :1], best_i[:, :1], 0)  # none found: index 0, not what topk left there
    best_i = torch.where(found, best_i, first).to(torch.int32)
    return best_i, torch.sqrt(torch.clamp(torch.where(found, exact, big), min=1e-12))


def interpolation(src_coord: torch.Tensor, src_batch: torch.Tensor, src_feat: torch.Tensor,
                  dst_coord: torch.Tensor, dst_batch: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Each destination point's features: the mean of its k nearest source
    points' features (same scene, `knn_query`) weighted by 1 / distance
    (floored at 1e-8) and normalised to sum 1 (pointops.interpolation,
    `functions/interpolation.py:8`). A destination with no source point in
    its scene reads row 0 at equal weights. The gather's VJP sums each
    source row's cotangents in a fixed order (`TakeRows`)."""
    idx, dist = knn_query(k, src_coord, src_batch, dst_coord, dst_batch)
    inv = 1.0 / torch.clamp(dist, min=1e-8)
    w = inv / inv.sum(dim=1, keepdim=True)
    nbr = TakeRows.apply(src_feat, idx.long().view(-1)).view(idx.shape + src_feat.shape[1:])
    return (nbr * w[..., None].to(src_feat.dtype)).sum(dim=1)


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
