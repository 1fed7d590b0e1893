"""Serialized patch attention (counterpart of `pointcept_tpu/ops/attention.py`).

The static patch layout of `PointBatch.patch_partition` makes attention a
dense [num_patches, K, K] problem per head. The port gathers the packed qkv
rows of every slot once (``qkv[slot_to_point]``, bf16) and hands them to the
patch-attention kernels (`PatchAttention`: the forward kernel, and the
backward kernel as its VJP); each point then reads its own slot's output row.
Both index ops are `TakeRows` gathers: their VJP sums the cotangents of the
slots that duplicate a point (scene tails, scenes smaller than a patch), as
JAX's `take` VJP does, in a fixed order. A stage's blocks share its
`RowRuns` (`patch_runs`), so its layouts are sorted once a step, all
orders together.

Not carried over from the JAX package, all TPU workarounds: the
identity-layout window splice (it avoided slot gathers on the TPU and gives
the same valid rows), the split per-head layout (a VMEM limit), and the
scene-blocked window attention.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernels.patch_attention import PatchAttention
from .segment_ops import RowRuns, TakeRows


def patch_runs(partitions: dict) -> dict:
    """A stage's patch layouts ``{order: (slot_to_point [P], point_to_slot
    [N])}`` as the `RowRuns` of their two gathers, ``{order: (slots read
    points: into N rows, points read slots: into P rows)}``; the layouts of
    one stage build their runs together (one sort for all orders)."""
    keys = list(partitions)
    s2p = [partitions[k][0] for k in keys]
    p2s = [partitions[k][1] for k in keys]
    reads = RowRuns.batch(s2p, p2s[0].shape[0])
    back = RowRuns.batch(p2s, s2p[0].shape[0])
    return {k: (reads[i], back[i]) for i, k in enumerate(keys)}


def patch_attention(
    qkv: torch.Tensor,  # [N, 3*C]
    slot_to_point: RowRuns,  # [P] slots read points (`patch_runs`)
    point_to_slot: RowRuns,  # [N] points read slots
    num_heads: int,
    patch_size: int,
    scale: Optional[float] = None,
    rpe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Returns [N, C] attention output per point, in qkv's dtype.

    The slots go through the patch-attention kernels. With ``rpe=(table,
    slot_coords)`` (PT-v3m1's relative position encoding: the f32 table
    [3 * (2b + 1), H] and the slots' grid coordinates [P, 3]) the biased
    kernels add each score's table entries, and the table gets its
    gradient; the JAX package runs the bias on its dense path, the port
    never builds the [nP, H, K, K] bias."""
    n, c3 = qkv.shape
    c = c3 // 3
    h = num_heads
    d = c // h
    k = patch_size
    p = slot_to_point.idx.shape[0]
    assert p % k == 0
    np_ = p // k
    if scale is None:
        scale = d**-0.5
    qkv_p = TakeRows.apply(qkv.to(compute_dtype), slot_to_point).reshape(np_, k, c3)
    if rpe is None:
        out = PatchAttention.apply(qkv_p.contiguous(), h, scale)
    else:
        table, slot_coords = rpe
        coords = slot_coords.to(torch.int32).reshape(np_, k, 3).contiguous()
        out = PatchAttention.apply(qkv_p.contiguous(), h, scale, table, coords)
    return TakeRows.apply(out.reshape(p, c), point_to_slot).to(qkv.dtype)
