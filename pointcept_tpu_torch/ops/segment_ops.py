"""Segment reductions (counterpart of `pointcept_tpu/ops/segment_ops.py`)."""

from __future__ import annotations

import torch


RUN_CHUNK = 64  # reads a first-level partial sum of `TakeRows`' VJP adds


def _build_runs(idx: torch.Tensor, rows: int) -> list:
    """The runs of each row of ``idx`` [O, M] over `rows` rows (see
    `RowRuns`), built together: one batched sort and one pass of each op
    for the O index tensors. Returns O (order, chunk_len, row_chunks)."""
    dev = idx.device
    o, m = idx.shape
    sorted_idx, order = torch.sort(idx, dim=1, stable=True)
    bounds = torch.searchsorted(sorted_idx, torch.arange(rows + 1, device=dev).expand(o, rows + 1).contiguous())
    length = bounds[:, 1:] - bounds[:, :-1]
    row_chunks = (length + (RUN_CHUNK - 1)) // RUN_CHUNK
    ends = torch.cumsum(row_chunks, 1)
    j = torch.arange(rows + (m + RUN_CHUNK - 1) // RUN_CHUNK, device=dev).expand(o, -1).contiguous()
    row = torch.searchsorted(ends, j, right=True)
    rc = torch.clamp(row, max=rows - 1)
    k = j - (ends.gather(1, rc) - row_chunks.gather(1, rc))
    chunk_len = torch.where(row < rows, torch.clamp(length.gather(1, rc) - k * RUN_CHUNK, 0, RUN_CHUNK), 0)
    return [(order[i], chunk_len[i], row_chunks[i]) for i in range(o)]


class RowRuns:
    """A gather index ``idx`` [M] into `rows` rows, and the runs of its
    fixed-order VJP, built at the first backward and kept: the gathers that
    share one index (the blocks of a stage share its patch layout) sort it
    once, and the indices made together by `RowRuns.batch` (a stage's
    layouts, one an order) are sorted together.

    A stable sort of `idx` lays each row's readers out in a run of
    consecutive positions, in the order they read it. Each run is cut into
    chunks of `RUN_CHUNK` positions (chunk j of row r holds its readers
    ``j * RUN_CHUNK ...``), laid out row by row in a chunk table of a static
    length, ``rows + ceil(M / RUN_CHUNK)``, that bounds their count; the
    tail of the table holds empty chunks. No value comes to the host."""

    def __init__(self, idx: torch.Tensor, rows: int):
        self.idx = idx.long()
        self.rows = int(rows)
        self._shared = None  # (the batch's holder, this index's place in it), `RowRuns.batch`
        self._runs = None

    @classmethod
    def batch(cls, indices, rows: int) -> list:
        """`RowRuns` of index tensors of one length over the same `rows`,
        whose runs are built together at the first backward of any."""
        runs = [cls(i, rows) for i in indices]
        holder = {"indices": [r.idx for r in runs], "runs": None}
        for n, r in enumerate(runs):
            r._shared = (holder, n)
        return runs

    def runs(self):
        """(order [M]: the positions sorted by row, stable; chunk_len [S]:
        each chunk's readers; row_chunks [rows]: each row's chunks)."""
        if self._runs is None:
            if self._shared is None:
                (self._runs,) = _build_runs(self.idx[None], self.rows)
            else:
                holder, n = self._shared
                if holder["runs"] is None:
                    holder["runs"] = _build_runs(torch.stack(holder["indices"]), self.rows)
                self._runs = holder["runs"][n]
        return self._runs


class TakeRows(torch.autograd.Function):
    """``x[idx]`` along rows (`index`: a `RowRuns`, or an index tensor over
    x's rows); VJP: each row's cotangents summed in a fixed order, in f32
    (f64 for f64 cotangents), and rounded once to x's dtype.

    The static layouts repeat rows by the thousand: every dead attention
    slot reads point 0, every padding point reads slot 0, and a scene
    smaller than one patch fills it by repeating its points (a 1,024-point
    cloud at PTv3's deepest stage fills its patch of 1,024 slots with a few
    dozen points). On the card the sum over each row's readers runs in two
    levels: `torch.segment_reduce` over the chunks of `RowRuns` (a chunk's
    readers in their order, one after another), then over each row's
    chunks. The same inputs give the same bits on every run, where the
    card's atomics (`index_add_`) add in the order they come; a row read
    once costs one read and two copies. On the CPU `index_add_` adds the
    readers one after another in their order, a fixed order already, and
    ten times faster than the CPU's `segment_reduce`. The sort-based VJP of ``x[idx]`` (`index_put_`
    with accumulation) serialises such duplicates and took most of the
    train step on the card. The submanifold gather conv, whose rows are
    read by many neighbours, pulls instead (`sparse_conv.NeighborGather`);
    a table that reads each row at most once adds (`TakeRowsOnce`)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, index) -> torch.Tensor:
        runs = index if isinstance(index, RowRuns) else RowRuns(index, x.shape[0])
        if runs.rows != x.shape[0]:
            raise ValueError(f"TakeRows: the index covers {runs.rows} rows, x has {x.shape[0]}")
        ctx.runs, ctx.dtype = runs, x.dtype
        return x[runs.idx]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        acc = torch.promote_types(g.dtype, torch.float32)  # f32, f64 for f64 cotangents
        if g.device.type == "cpu":
            # the CPU's index_add_ adds the readers one after another, in their order
            gx = torch.zeros((ctx.runs.rows,) + tuple(g.shape[1:]), dtype=acc, device=g.device)
            return gx.index_add_(0, ctx.runs.idx, g.to(acc)).to(ctx.dtype), None
        order, chunk_len, row_chunks = ctx.runs.runs()
        part = torch.segment_reduce(g.to(acc)[order], "sum", lengths=chunk_len, axis=0, unsafe=True, initial=0)
        gx = torch.segment_reduce(part, "sum", lengths=row_chunks, axis=0, unsafe=True, initial=0)
        return gx.to(ctx.dtype), None


class TakeRowsOnce(torch.autograd.Function):
    """``x[idx]`` for an index under which each row has at most one reader
    whose cotangent may be nonzero (the inverse conv's (parent, slot)
    table); VJP: the cotangent rows added into an f32 buffer with
    `index_add_`, cast to x's dtype. One nonzero term a row, so the sum is
    exact in any order."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype = x.shape[0], x.dtype
        return x[idx]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        gx = torch.zeros((ctx.rows,) + tuple(g.shape[1:]), dtype=torch.float32, device=g.device)
        return gx.index_add_(0, idx, g.float()).to(ctx.dtype), None


def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                   reduce: str = "sum") -> torch.Tensor:
    """Reduce rows of `data` by segment id; ids >= num_segments are dropped.

    reduce in {sum, mean, max}. Empty segments give 0 for every reduction."""
    ids = torch.clamp(segment_ids.long(), max=num_segments)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    idx = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    if reduce == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device).index_add_(0, ids, data)
    elif reduce == "mean":
        s = torch.zeros(shape, dtype=data.dtype, device=data.device).index_add_(0, ids, data)
        c = torch.zeros(num_segments + 1, dtype=data.dtype, device=data.device).index_add_(
            0, ids, torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
        )
        out = s / torch.clamp(c, min=1).view((-1,) + (1,) * (data.dim() - 1))
    elif reduce == "max":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device).scatter_reduce_(
            0, idx, data, reduce="amax", include_self=False
        )
    else:
        raise ValueError(f"unknown reduce {reduce}")
    return out[:num_segments]


def sorted_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean of the rows of each segment, for non-decreasing `segment_ids`
    (ids >= num_segments dropped; empty segments give 0), in a fixed order:
    the differences of f64 prefix sums at the segments' bounds, so the same
    inputs give the same bits on the card, where `index_add_`'s f32 atomics
    would not. The pooled coordinates of SSL models feed nearest-neighbour
    matches, which such bits could flip."""
    ids = torch.clamp(segment_ids.long(), max=num_segments)
    # the scan runs along rows of the transposed data: a scan down the
    # columns of [N, 3] takes ~15 ms a call on the card
    cols = data.reshape(data.shape[0], -1).double().T.contiguous()
    prefix = torch.cat([torch.zeros((cols.shape[0], 1), dtype=torch.float64, device=data.device),
                        torch.cumsum(cols, dim=1)], dim=1)
    seg = torch.arange(num_segments, device=data.device)
    start = torch.searchsorted(ids, seg)
    end = torch.searchsorted(ids, seg, right=True)
    mean = (prefix[:, end] - prefix[:, start]) / torch.clamp(end - start, min=1)
    return mean.T.reshape((num_segments,) + tuple(data.shape[1:])).to(data.dtype)


def fixed_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, mask: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Mean of the rows of `data` where `mask` holds, by segment id in any
    order (ids outside [0, num_segments) dropped, empty segments 0), in f32
    or wider and in a fixed order: a stable sort by id, then
    `sorted_segment_mean`."""
    ids = torch.where(mask & (segment_ids >= 0), segment_ids.long(), num_segments)
    ids, order = torch.sort(ids, stable=True)
    acc = torch.promote_types(data.dtype, torch.float32)
    return sorted_segment_mean(data.to(acc)[order], ids, num_segments)


def masked_segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor, mask: torch.Tensor,
                          num_segments: int, reduce: str = "sum") -> torch.Tensor:
    """Reduce the rows of `data` where `mask` holds by segment id, for a few
    segments (scenes or views): reduce in {sum, mean, min}; ids outside
    [0, num_segments) and empty segments give 0. One dense [segments, N]
    selection reduced along N, so the sums take a fixed order on every
    device (no atomics) and are differentiable."""
    ids = torch.where(mask, segment_ids.long(), -1)
    sel = ids[None, :] == torch.arange(num_segments, device=data.device)[:, None]  # [S, N]
    sel = sel.view(sel.shape + (1,) * (data.dim() - 1))
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if reduce in ("sum", "mean"):
        out = torch.where(sel, data[None], zero).sum(dim=1)
        if reduce == "mean":
            count = sel.sum(dim=1).to(data.dtype)
            out = out / torch.clamp(count, min=1)
        return out
    if reduce == "min":
        out = torch.where(sel, data[None], torch.full((), float("inf"), dtype=data.dtype,
                                                      device=data.device)).amin(dim=1)
        return torch.where(torch.isfinite(out), out, zero)
    raise ValueError(f"unknown reduce {reduce}")
