"""Segment reductions (counterpart of `pointcept_tpu/ops/segment_ops.py`)."""

from __future__ import annotations

import torch


class TakeRows(torch.autograd.Function):
    """``x[idx]`` along rows; VJP: the cotangent rows added into an f32
    buffer with `index_add_` (native f32 atomics on the card), cast to x's
    dtype.

    The static layouts repeat rows by the thousand: every dead attention
    slot reads point 0, every padding point reads slot 0, every missing
    child of a strided conv reads row 0. The autograd VJP (`index_put_`
    with accumulation) serialises such duplicates, and took most of the
    train step on the card. On the card a row repeated more than twice with
    nonzero cotangents (a scene smaller than one patch) sums in the order
    the atomics take; the f32 sum is rounded once. The submanifold gather
    conv, whose rows are read by many neighbours, pulls instead
    (`sparse_conv.NeighborGather`)."""

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
