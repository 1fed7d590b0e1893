"""Point Transformer V2 (PT-v2m1, PT-v2m2, PT-v2m3; counterpart of
`pointcept_tpu/models/point_transformer_v2/point_transformer_v2.py`).

Patch embedding (Linear + PointBatchNorm + ReLU, then a block sequence over
each point's k nearest neighbours) -> encoder stages of [GridPool + blocks]
-> decoder stages of [UnpoolWithSkip + blocks] -> the seg head. A block is
fc1 -> norm -> grouped vector attention over the sequence's kNN -> norm ->
fc3 -> norm -> drop path -> the residual's ReLU.

Every capacity is static, as in the JAX package: a stage's rows are
``_round_up(max(ceil(cap * f), 128), 128)`` of the previous stage's, and
GridPool keeps the first clusters in key order up to that capacity; the
points of clusters past it are dropped and counted (``pool_overflow``, one
count a pooling). The rows of every stage are scene-contiguous (collate
concatenates scenes, pooled keys lead with the batch id), which bounds each
kNN query chunk to its scenes' rows (`ops.pointops.knn_query`).

Sums on the card take a fixed order, so two runs give the same bits: the
neighbour gathers ``k[ref_idx]`` and ``v[ref_idx]`` and the unpooling's
``x[cluster]`` back-propagate through `TakeRows` (each sequence's blocks
share one `RowRuns` of its kNN), GridPool's pooled coordinates (which feed
the next stage's kNN) are a `sorted_segment_mean` over the key order, the
scene minimum a dense `masked_segment_reduce`, and the pooled features' max
splits its cotangent evenly among tied rows (`scatter_reduce`'s ``amax``,
as the JAX package's ``segment_max``).

PT-v2m1 (the reference's "origin") starts the weight encoding with a
GroupedLinear (a per-channel scale, then a sum over each group's channels);
PT-v2m3 puts `PDBatchNorm` (one norm a condition, names ``bns.{i}`` / ``bn``,
momentum 0.01 and eps 1e-3 as the JAX package's PDNorm) in place of the
blocks', the poolings' and the unpoolings' norms; the attention's own norms,
the patch embedding's and the seg head's stay PointBatchNorm.

Parameter names follow the reference Pointcept state dict
(`point_transformer_v2m2_base.py`: ``patch_embed.proj.0``,
``enc_stages.0.down.norm.norm``, ``dec_stages.0.up.proj_skip.1.norm``,
``...blocks.blocks.0.attn.linear_p_bias.3``, ``seg_head.3``), so the JAX
package's `convert_state_dict(sd, "PT-v2m2")` reads them directly.

Not ported: attention dropout (``attn_drop_rate`` raises above 0).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import serialization as ser
from ...ops.pointops import interpolation, knn_query
from ...ops.segment_ops import RowRuns, TakeRows, masked_segment_reduce, segment_reduce, sorted_segment_mean
from ..builder import MODELS
from ..modules import DropPath, Linear, MaskedBatchNorm, PDBatchNorm
from ..utils.structure import PointBatch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PointBatchNorm(nn.Module):
    """The reference's PointBatchNorm (`.norm`, a BatchNorm1d at momentum 0.1
    and eps 1e-5, the JAX package's `PointBN`): a `MaskedBatchNorm` over the
    rows where `mask` holds, of [N, C] or of [N, S, C] flattened to
    [N * S, C] with each point's mask over its S rows."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.norm = MaskedBatchNorm(channels, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        if x.dim() == 3:
            mask = mask[:, None].expand(shape[0], shape[1]).reshape(-1)
            x = x.reshape(-1, shape[-1])
        return self.norm(x, mask).view(shape)


def _norm(channels: int, pd: Optional[dict]) -> nn.Module:
    """A block-level norm: PointBatchNorm, or PT-v2m3's `PDBatchNorm`."""
    if pd is None:
        return PointBatchNorm(channels)
    return PDBatchNorm(channels, pd["conditions"], pd["decouple"], pd["adaptive"], pd["context_channels"])


def _apply(norm: nn.Module, x: torch.Tensor, mask: torch.Tensor, pb: PointBatch) -> torch.Tensor:
    if isinstance(norm, PDBatchNorm):
        return norm(x, mask, pb.condition, pb.context)
    return norm(x, mask)


class GroupedLinear(nn.Module):
    """PT-v2m1's weight-encoding input (reference
    `point_transformer_v2m1_origin.py:24-62`): x times a per-channel weight
    [1, C], summed over each of `groups` groups of channels."""

    def __init__(self, in_features: int, groups: int):
        super().__init__()
        if in_features % groups:
            raise ValueError(f"GroupedLinear: {in_features} channels in {groups} groups")
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(1, in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * self.weight).view(x.shape[:-1] + (self.groups, -1)).sum(dim=-1)


def _mlp3(in_channels: int, channels: int, out_channels: int, first=None) -> nn.Sequential:
    """The reference's Sequential(Linear, PointBatchNorm, ReLU, Linear)
    (`first` in place of the first Linear); called through `_run_mlp3`."""
    return nn.Sequential(first if first is not None else Linear(in_channels, channels), PointBatchNorm(channels),
                         nn.ReLU(), Linear(channels, out_channels))


def _run_mlp3(seq: nn.Sequential, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return seq[3](F.relu(seq[1](seq[0](x), mask)))


class GroupedVectorAttention(nn.Module):
    """Reference `GroupedVectorAttention` (`point_transformer_v2m2_base.py:48-129`):
    q, k (Linear + PointBatchNorm + ReLU) and v; each point's relation to its
    k neighbours ``key - q`` (times the position multiplier, plus the
    position bias, which the values take too), the weight encoding to
    `groups` weights, their softmax over the neighbours in f32, and the
    weighted sum of the neighbours' values, group by group."""

    def __init__(self, embed_channels: int, groups: int, qkv_bias: bool = True, pe_multiplier: bool = False,
                 pe_bias: bool = True, grouped_linear: bool = False):
        super().__init__()
        c = embed_channels
        if c % groups:
            raise ValueError(f"GroupedVectorAttention: {c} channels in {groups} groups")
        self.groups = groups
        self.linear_q = nn.Sequential(Linear(c, c, bias=qkv_bias), PointBatchNorm(c), nn.ReLU())
        self.linear_k = nn.Sequential(Linear(c, c, bias=qkv_bias), PointBatchNorm(c), nn.ReLU())
        self.linear_v = Linear(c, c, bias=qkv_bias)
        if pe_multiplier:
            self.linear_p_multiplier = _mlp3(3, c, c)
        if pe_bias:
            self.linear_p_bias = _mlp3(3, c, c)
        self.weight_encoding = _mlp3(c, groups, groups, GroupedLinear(c, groups) if grouped_linear else None)

    def forward(self, feat: torch.Tensor, coord: torch.Tensor, runs: RowRuns, mask: torch.Tensor) -> torch.Tensor:
        n, c = feat.shape
        s = runs.idx.shape[0] // n
        q = F.relu(self.linear_q[1](self.linear_q[0](feat), mask))
        k = F.relu(self.linear_k[1](self.linear_k[0](feat), mask))
        v = self.linear_v(feat)
        key = TakeRows.apply(k, runs).view(n, s, c)
        value = TakeRows.apply(v, runs).view(n, s, c)
        pos = coord[runs.idx].view(n, s, 3) - coord[:, None, :]
        relation = key - q[:, None, :]
        if hasattr(self, "linear_p_multiplier"):
            relation = relation * _run_mlp3(self.linear_p_multiplier, pos, mask)
        if hasattr(self, "linear_p_bias"):
            peb = _run_mlp3(self.linear_p_bias, pos, mask)
            relation = relation + peb
            value = value + peb
        w = _run_mlp3(self.weight_encoding, relation, mask)  # [N, S, groups]
        # every slot holds a neighbour (the JAX package's `ref_idx >= 0` mask is always true)
        w = torch.softmax(w.float(), dim=1).to(feat.dtype)
        return (value.view(n, s, self.groups, c // self.groups) * w[..., None]).sum(dim=1).reshape(n, c)


class Block(nn.Module):
    """Reference `Block` (`:132-178`)."""

    def __init__(self, embed_channels: int, groups: int, qkv_bias: bool = True, pe_multiplier: bool = False,
                 pe_bias: bool = True, grouped_linear: bool = False, drop_path: float = 0.0,
                 pd: Optional[dict] = None):
        super().__init__()
        c = embed_channels
        self.fc1 = Linear(c, c, bias=False)
        self.fc3 = Linear(c, c, bias=False)
        self.norm1, self.norm2, self.norm3 = _norm(c, pd), _norm(c, pd), _norm(c, pd)
        self.attn = GroupedVectorAttention(c, groups, qkv_bias, pe_multiplier, pe_bias, grouped_linear)
        self.drop_path = DropPath(drop_path)

    def forward(self, pb: PointBatch, feat: torch.Tensor, runs: RowRuns,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        mask = pb.mask
        x = F.relu(_apply(self.norm1, self.fc1(feat), mask, pb))
        x = self.attn(x, pb.coord, runs, mask)
        x = F.relu(_apply(self.norm2, x, mask, pb))
        x = _apply(self.norm3, self.fc3(x), mask, pb)
        return F.relu(feat + self.drop_path(x, generator))


class BlockSequence(nn.Module):
    """Reference `BlockSequence` (`:181-226`): one kNN of the stage's points
    (`neighbours` of each, within its scene), shared by its blocks, and its
    `RowRuns` shared by their gathers."""

    def __init__(self, depth: int, neighbours: int, drop_path_rates: Sequence[float], **block):
        super().__init__()
        self.neighbours = neighbours
        self.blocks = nn.ModuleList([Block(drop_path=drop_path_rates[i] if i < len(drop_path_rates) else 0.0,
                                           **block) for i in range(depth)])

    def forward(self, pb: PointBatch, feat: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        ref_idx, _ = knn_query(self.neighbours, pb.coord, torch.where(pb.mask, pb.batch, -1))
        runs = RowRuns(ref_idx.view(-1), feat.shape[0])
        for block in self.blocks:
            feat = block(pb, feat, runs, generator)
        return feat


class GridPool(nn.Module):
    """Reference `GridPool` (`:229-269`): Linear + norm + ReLU, then the
    points' voxel-grid partition at `grid_size` from each scene's minimum:
    one row a voxel, in z-order key order at depth 16 (the grid clipped to
    2**16 - 1, padding at the batch sentinel), at most `out_capacity` rows.
    A voxel's row holds its points' mean coordinate and the max of their
    features. Returns (the pooled PointBatch, each point's row, ``out_capacity``
    where it was dropped or is padding, and the number of valid points
    dropped)."""

    def __init__(self, in_channels: int, out_channels: int, grid_size: float, pd: Optional[dict] = None):
        super().__init__()
        self.grid_size = grid_size
        self.fc = Linear(in_channels, out_channels, bias=False)
        self.norm = _norm(out_channels, pd)

    def forward(self, pb: PointBatch, feat: torch.Tensor, out_capacity: int):
        m, n, dev = out_capacity, pb.capacity, pb.device
        mask, batch = pb.mask, pb.batch
        feat = F.relu(_apply(self.norm, self.fc(feat), mask, pb))
        start = masked_segment_reduce(pb.coord, batch, mask, pb.num_scenes, "min")
        b = torch.clamp(batch, 0, pb.num_scenes - 1).long()
        grid = torch.floor((pb.coord - start[b]) / self.grid_size).to(torch.int32)
        grid = torch.clamp(grid, 0, (1 << 16) - 1)
        keys = ser.encode(grid, torch.where(mask, batch, ser.BATCH_SENTINEL), 16, "z")
        order = ser.argsort_keys(keys).long()
        sk = keys[order]
        valid_sorted = mask[order]
        prev_eq = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), ser.keys_equal(sk[1:], sk[:-1])])
        head = valid_sorted & ~prev_eq
        cluster_sorted = torch.cumsum(head.to(torch.int32), 0) - 1
        kept = valid_sorted & (cluster_sorted < m)
        cl_sorted = torch.where(kept, cluster_sorted, m)  # non-decreasing: kept clusters, then m
        cluster = torch.full((n,), m, dtype=torch.int32, device=dev).scatter(0, order, cl_sorted.to(torch.int32))
        dropped = (valid_sorted & ~kept).sum().to(torch.int32)
        coord = sorted_segment_mean(pb.coord[order], cl_sorted, m)
        new_feat = segment_reduce(feat, cluster, m, "max")
        head_target = torch.where(head & (cluster_sorted < m), cluster_sorted, m).long()
        new_batch = torch.full((m + 1,), -1, dtype=batch.dtype, device=dev).index_put((head_target,), batch[order])
        pooled = PointBatch(coord=coord, feat=None, grid_coord=None, batch=new_batch[:m], num_scenes=pb.num_scenes,
                            condition=pb.condition, context=pb.context)
        return pooled, new_feat, cluster, dropped


class UnpoolWithSkip(nn.Module):
    """Reference `UnpoolWithSkip` (`:272-316`): the coarse features through
    Linear + norm + ReLU, brought to the skip's points by their cluster
    (``map``; zero for a dropped point) or by 3-NN interpolation
    (``interp``), plus the skip's features through Linear + norm + ReLU."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int, backend: str = "map",
                 pd: Optional[dict] = None):
        super().__init__()
        if backend not in ("map", "interp"):
            raise ValueError(f"UnpoolWithSkip: backend must be 'map' or 'interp', got {backend!r}")
        self.backend = backend
        self.proj = nn.Sequential(Linear(in_channels, out_channels), _norm(out_channels, pd), nn.ReLU())
        self.proj_skip = nn.Sequential(Linear(skip_channels, out_channels), _norm(out_channels, pd), nn.ReLU())

    def forward(self, pb: PointBatch, feat: torch.Tensor, skip: PointBatch, skip_feat: torch.Tensor,
                cluster: torch.Tensor) -> torch.Tensor:
        x = F.relu(_apply(self.proj[1], self.proj[0](feat), pb.mask, pb))
        if self.backend == "map":
            m = feat.shape[0]
            up = TakeRows.apply(x, torch.clamp(cluster, max=m - 1).long())
            up = torch.where((cluster < m)[:, None], up, torch.zeros((), dtype=up.dtype, device=up.device))
        else:
            up = interpolation(pb.coord, torch.where(pb.mask, pb.batch, -1), x, skip.coord,
                               torch.where(skip.mask, skip.batch, -1))
        s = F.relu(_apply(self.proj_skip[1], self.proj_skip[0](skip_feat), skip.mask, skip))
        return up + s


@MODELS.register_module("PT-v2m2")
class PointTransformerV2(nn.Module):
    """PT-v2m2 backbone; `forward(pb, generator)` returns (the PointBatch with
    the seg head's logits as ``feat``, or the decoder's features where
    ``num_classes`` is 0; diagnostics: ``pool_overflow``, the points each
    GridPool dropped, and an empty ``block_overflow``). In train mode the
    drop-path masks are drawn from `generator`.

    ``num_classes`` defaults to 0, the features: the reference takes it
    without a default, every DefaultSegmentor config names it, and the
    CAC-over-PT-v2 configs, whose ``_delete_`` drops their base's
    ``num_classes=0``, read the backbone's features (the JAX package's
    default of 20 builds a seg head there, and CAC's classifier fails on
    its logits)."""

    grouped_linear = False
    default_conditions: tuple = ()

    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 0,
        patch_embed_depth: int = 1,
        patch_embed_channels: int = 48,
        patch_embed_groups: int = 6,
        patch_embed_neighbours: int = 8,
        enc_depths: Sequence[int] = (2, 2, 6, 2),
        enc_channels: Sequence[int] = (96, 192, 384, 512),
        enc_groups: Sequence[int] = (12, 24, 48, 64),
        enc_neighbours: Sequence[int] = (16, 16, 16, 16),
        dec_depths: Sequence[int] = (1, 1, 1, 1),
        dec_channels: Sequence[int] = (48, 96, 192, 384),
        dec_groups: Sequence[int] = (6, 12, 24, 48),
        dec_neighbours: Sequence[int] = (16, 16, 16, 16),
        grid_sizes: Sequence[float] = (0.06, 0.12, 0.24, 0.48),
        attn_qkv_bias: bool = True,
        pe_multiplier: bool = False,
        pe_bias: bool = True,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        unpool_backend: str = "map",
        pool_capacity_factors: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
        conditions: Optional[Sequence[str]] = None,
        norm_decouple: bool = True,
        norm_adaptive: bool = False,
        context_channels: int = 256,
    ):
        super().__init__()
        if attn_drop_rate:
            raise NotImplementedError(f"{type(self).__name__}: attn_drop_rate={attn_drop_rate} is not ported")
        n = len(enc_depths)
        if not (len(enc_channels) == len(enc_groups) == len(enc_neighbours) == len(dec_depths)
                == len(dec_channels) == len(dec_groups) == len(dec_neighbours) == len(grid_sizes) == n):
            raise ValueError(f"{type(self).__name__}: the per-stage settings differ in length")
        conditions = self.default_conditions if conditions is None else tuple(conditions)
        pd = (dict(conditions=conditions, decouple=norm_decouple, adaptive=norm_adaptive,
                   context_channels=context_channels) if conditions else None)
        self.num_stages = n
        self.pool_capacity_factors = tuple(pool_capacity_factors)
        attn = dict(qkv_bias=attn_qkv_bias, pe_multiplier=pe_multiplier, pe_bias=pe_bias,
                    grouped_linear=self.grouped_linear, pd=pd)
        enc_dp = np.linspace(0, drop_path_rate, sum(enc_depths)).tolist()
        dec_dp = np.linspace(0, drop_path_rate, sum(dec_depths)).tolist()

        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Sequential(Linear(in_channels, patch_embed_channels, bias=False),
                                              PointBatchNorm(patch_embed_channels), nn.ReLU())
        self.patch_embed.blocks = BlockSequence(patch_embed_depth, patch_embed_neighbours, (),
                                                embed_channels=patch_embed_channels, groups=patch_embed_groups,
                                                **attn)
        self.enc_stages = nn.ModuleList()
        self.dec_stages = nn.ModuleList()
        enc_ch = [patch_embed_channels] + list(enc_channels)
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        for i in range(n):
            stage = nn.Module()
            stage.down = GridPool(enc_ch[i], enc_channels[i], grid_sizes[i], pd)
            stage.blocks = BlockSequence(enc_depths[i], enc_neighbours[i],
                                         enc_dp[sum(enc_depths[:i]) : sum(enc_depths[: i + 1])],
                                         embed_channels=enc_channels[i], groups=enc_groups[i], **attn)
            self.enc_stages.append(stage)
            stage = nn.Module()
            stage.up = UnpoolWithSkip(dec_ch[i + 1], enc_ch[i], dec_channels[i], unpool_backend, pd)
            stage.blocks = BlockSequence(dec_depths[i], dec_neighbours[i],
                                         dec_dp[sum(dec_depths[:i]) : sum(dec_depths[: i + 1])],
                                         embed_channels=dec_channels[i], groups=dec_groups[i], **attn)
            self.dec_stages.append(stage)
        self.out_channels = num_classes if num_classes > 0 else dec_channels[0]
        if num_classes > 0:
            self.seg_head = nn.Sequential(Linear(dec_channels[0], dec_channels[0]),
                                          PointBatchNorm(dec_channels[0]), nn.ReLU(),
                                          Linear(dec_channels[0], num_classes))

    def stage_capacities(self, capacity: int) -> list:
        """The rows of each pooled stage (`_round_up(max(ceil(cap * f), 128), 128)`)."""
        caps = []
        for f in self.pool_capacity_factors:
            capacity = _round_up(max(int(math.ceil(capacity * f)), 128), 128)
            caps.append(capacity)
        return caps

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None):
        if generator is None and self.training and any(
                b.drop_path.rate > 0 for s in list(self.enc_stages) + list(self.dec_stages) for b in s.blocks.blocks):
            raise ValueError(f"{type(self).__name__}: train mode draws its drop-path masks from an explicit generator")
        coord_pb = pb.replace(grid_coord=None, serialized_keys=None, serialized_order=None,
                              serialized_inverse=None, feat=None)
        proj = self.patch_embed.proj
        x = F.relu(proj[1](proj[0](pb.feat), pb.mask))
        x = self.patch_embed.blocks(coord_pb, x, generator)
        skips, dropped = [], []
        state = (coord_pb, x)
        for stage, cap in zip(self.enc_stages, self.stage_capacities(pb.capacity)):
            pooled, feat, cluster, overflow = stage.down(state[0], state[1], cap)
            dropped.append(overflow)
            skips.append(state + (cluster,))
            state = (pooled, stage.blocks(pooled, feat, generator))
        for i in reversed(range(self.num_stages)):
            skip, skip_feat, cluster = skips[i]
            stage = self.dec_stages[i]
            up = stage.up(state[0], state[1], skip, skip_feat, cluster)
            state = (skip, stage.blocks(skip, up, generator))
        feat = state[1]
        if hasattr(self, "seg_head"):
            head = self.seg_head
            feat = head[3](F.relu(head[1](head[0](feat), pb.mask)))
        return pb.replace(feat=feat), {"pool_overflow": dropped, "block_overflow": []}


@MODELS.register_module("PT-v2m1")
class PointTransformerV2M1(PointTransformerV2):
    """The reference's "origin" (`point_transformer_v2m1_origin.py`): PT-v2m2
    with a GroupedLinear weight-encoding input (``weight_encoding.0.weight``
    [1, C])."""

    grouped_linear = True


@MODELS.register_module("PT-v2m3")
class PointTransformerV2M3(PointTransformerV2):
    """The PDNorm variant (`point_transformer_v2m3_pdnorm.py`): PT-v2m2 with
    the blocks', poolings' and unpoolings' norms one `PDBatchNorm` of
    ``conditions`` (by default ScanNet, S3DIS, Structured3D), decoupled and
    adaptive as asked; each reads the batch's condition (and context)."""

    default_conditions = ("ScanNet", "S3DIS", "Structured3D")
