"""Point Transformer V3 (PT-v3m1), eval and train forward (counterpart of
`pointcept_tpu/models/point_transformer_v3/point_transformer_v3.py`).

Serialization -> SubM k5 stem -> U-Net of [SerializedPooling + Block x d]
encoder stages and [SerializedUnpooling + Block x d] decoder stages; a Block
is xCPE (SubM k3 conv + linear + LN) + serialized patch attention + MLP with
pre-norm residuals. Every capacity is static, and the block-dense conv engine
serves stages of at least `block_engine_min_points` points while smaller
stages use gather-GEMM rule maps.

``block_conv_fused=True`` runs the block-dense convs as the fused implicit
GEMM (`FusedBlockConv`), the JAX package's ``BLOCK_CONV_FUSED=1``; the
default is `F.conv3d` over materialised halos (the JAX package's default
`lax.conv` route).

Two geometry routes, as in the JAX package:
* unshuffled (eval, or train with ``shuffle_orders=False``): only the orders
  the blocks read are sorted, and with ``sorted_layout`` the batch is pinned
  to z order after serialization, so order 0 is the identity at every stage;
* shuffled (train with ``shuffle_orders``): every order is sorted at every
  stage and the orders are permuted after serialization and after every
  pooling (draws from the caller's generator). Nothing is pinned: block
  tables re-sort by the z curve, pooling reduces through a non-identity
  order 0, and pooled keys are gathered from the shifted keys.
Train mode also takes BatchNorm statistics over the valid rows and applies
the drop-path schedule (a linspace over the encoder depths, reversed slices
in the decoder).

Parameter names follow the reference Pointcept state dict
(`backbone.enc.enc0.block0.cpe.0.weight`, ...), so reference checkpoints and
the JAX package's converter read them directly. Conv weights are
``[k^3, Cin, Cout]`` in `kernel_offsets` order.

`build_geometry(pb)` builds the feature-independent half of the eval
forward once (serialization, the pin to order 0, block tables or rule maps,
patch partitions, pooling clusters), and `forward(pb, precomputed=...)`
moves a batch's features through it: the tester's fragments of one voxel
grid share it.

PT-v3m2 (`PT-v3m2`, the Sonata backbone) adds the linear stem
(``embed_mode="linear"``: Linear + LayerNorm + GELU) with an optional
learned ``mask_token`` substituted at a caller's ``patch_mask``, LayerScale
(``layer_scale``: ``ls1``/``ls2`` gammas on the attention and MLP
branches) and ``enc_mode`` (no decoder: `forward` also returns the skip
chain of ``(PointBatch, cluster, stage context)`` that SSL models'
``up_cast`` pops; nothing is pinned to order 0, and pooled stages carry the
mean of ``origin_coord``).

PT-v3m3 (`PT-v3m3`, the Utonia backbone) is PT-v3m2 with 3D RoPE
(``rope_base``): q and k are rotated by each point's coordinate
(`ops/pointrope.py`) after the qkv projection, and in train mode the RoPE
positions may be shifted (``shift_coords``), jittered per axis
(``jitter_coords``) and rescaled (``rescale_coords``), one draw per
attention call from the caller's generator. Its head dims are multiples of
6 (Utonia's is 18).

``lora_rank`` (m1, m2 and m3; `DefaultLORASegmentorV2`) adds a low-rank
adapter to each attention's qkv, as the JAX package computes it:
``qkv + (x @ lora_a) @ lora_b`` with ``lora_a [C, r]`` drawn N(0, 0.02)
and ``lora_b [r, 3C]`` made at zero, no scaling and no dropout, before RoPE
and the patch partition.

PDNorm (``pdnorm_bn``, ``pdnorm_ln``: the Point Prompt Training
backbones) replaces the norms the JAX package's `apply_bn` / `apply_ln`
cover (the stem's, the blocks' cpe, norm1 and norm2, the pooling's and the
unpooling's two) by `PDNorm`s of ``pdnorm_conditions``, decoupled
(``pdnorm_decouple``) and adaptive (``pdnorm_adaptive``) as asked; each reads
the batch's ``condition`` and ``context``, which pooling and unpooling carry.
``pdnorm_affine`` is accepted and, as in the JAX package, without effect
(the norms are affine).

``enable_rpe`` (the S3DIS RPE config) adds each attention's relative
position encoding: a learned table ``attn.rpe.rpe_table`` [3 * (2b + 1), H]
(b = `rpe_bound` of the patch size: 15 at 128), made truncated normal at
0.02, whose entries at each (query, key) pair's clipped relative grid
coordinate are summed over the three axes and added to the score, inside
the attention kernels (`patch_attention_rpe_fwd` / `_bwd`).

Not ported: attention and projection dropout, host geometry and the
scene-blocked layout (whose window attention also refuses RPE, as the JAX
package asserts). Each raises when asked for.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...ops import serialization as ser
from ...ops.attention import patch_attention, patch_runs
from ...ops.block_conv import block_subm_conv, build_block_tables, default_block_capacity
from ...ops.kernels.patch_attention import rpe_bound
from ...ops.pointrope import point_rope
from ...ops.segment_ops import segment_reduce, sorted_segment_mean
from ...ops.sparse_conv import build_subm_neighbor_map, gather_conv, k3_columns_of_k5
from ..builder import MODELS
from ..modules import DropPath, Linear, MLP, apply_norm, gelu, make_norm
from ..utils.structure import PointBatch, serialization_depth


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SubMConv(nn.Module):
    """Submanifold sparse conv: the block-dense engine when given block
    tables (the fused implicit GEMM with `fused`), gather-GEMM over a rule
    map otherwise. Weight [k^3, Cin, Cout]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, bias: bool = True,
                 fused: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.fused = fused
        self.weight = nn.Parameter(torch.empty(kernel_size**3, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, feat: torch.Tensor, geom) -> torch.Tensor:
        if isinstance(geom, dict):
            return block_subm_conv(feat, geom, self.weight, self.bias, kernel_size=self.kernel_size,
                                   fused=self.fused)
        return gather_conv(feat, geom, self.weight, self.bias, compute_dtype=torch.bfloat16)


class RPE(nn.Module):
    """The relative position encoding's table (reference `RPE`, ptv3 base
    `:29-48`): ``rpe_table`` [3 * (2b + 1), H] f32, b = `rpe_bound` of the
    patch size, one block of 2b + 1 rows an axis. The attention kernels read
    it (`patch_attention_rpe_fwd`)."""

    def __init__(self, patch_size: int, num_heads: int):
        super().__init__()
        self.pos_bnd = rpe_bound(patch_size)
        self.rpe_table = nn.Parameter(torch.zeros(3 * (2 * self.pos_bnd + 1), num_heads))


class SerializedAttention(nn.Module):
    """qkv projection (with `lora_rank`, plus its low-rank adapter), patch
    attention, output projection; with `rope` (a dict of ``base`` and the
    optional train-time ``shift``, ``jitter`` and ``rescale`` of the
    positions) q and k are rotated by the points' coordinates first; with
    `enable_rpe` the scores take the `RPE` table's bias at the slots' grid
    coordinates."""

    def __init__(self, channels, num_heads, patch_size, qkv_bias=True, qk_scale=None,
                 compute_dtype=None, rope: Optional[dict] = None, lora_rank: int = 0,
                 enable_rpe: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.scale = qk_scale or (channels // num_heads) ** -0.5
        self.rope = rope
        self.qkv = Linear(channels, 3 * channels, bias=qkv_bias, compute_dtype=compute_dtype)
        self.proj = Linear(channels, channels, compute_dtype=compute_dtype)
        if enable_rpe:
            self.rpe = RPE(patch_size, num_heads)
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(channels, lora_rank))
            self.lora_b = nn.Parameter(torch.zeros(lora_rank, 3 * channels))

    def rope_positions(self, coord: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The RoPE positions: the coordinates, in train mode shifted by one
        uniform draw in (-shift, shift) per axis, scaled by exp of one draw in
        (-log jitter, log jitter) per axis and by exp of one draw in
        (-log rescale, log rescale), each where set (jitter and rescale above
        1), all from `generator` (as the JAX package draws them per call)."""
        r = self.rope
        shift, jitter, rescale = r.get("shift"), r.get("jitter"), r.get("rescale")
        active = (shift is not None and shift > 0) or (jitter is not None and jitter > 1.0) or (
            rescale is not None and rescale > 1.0)
        if not (self.training and active):
            return coord
        if generator is None:
            raise ValueError("PT-v3m3: train mode draws its RoPE coordinate augmentations from an explicit generator")

        def uniform(shape, bound):
            u = torch.rand(shape, generator=generator, device=coord.device, dtype=torch.float32)
            return (2.0 * u - 1.0) * bound

        if shift is not None and shift > 0:
            coord = coord + uniform((1, 3), shift)
        if jitter is not None and jitter > 1.0:
            coord = coord * torch.exp(uniform((1, 3), math.log(jitter)))
        if rescale is not None and rescale > 1.0:
            coord = coord * torch.exp(uniform((1, 1), math.log(rescale)))
        return coord

    def forward(self, feat: torch.Tensor, partition, coord: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                grid_coord: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`grid_coord` [N, 3]: the stage's grid (read with `enable_rpe`)."""
        slot_to_point, point_to_slot = partition
        qkv = self.qkv(feat)
        if hasattr(self, "lora_a"):
            qkv = qkv + (feat @ self.lora_a.to(feat.dtype)) @ self.lora_b.to(feat.dtype)
        if self.rope is not None:
            n, h = qkv.shape[0], self.num_heads
            qkv4 = qkv.reshape(n, 3, h, -1)
            pos = self.rope_positions(coord, generator)
            q, k = (point_rope(qkv4[:, i].transpose(0, 1), pos, freq=self.rope["base"]).transpose(0, 1)
                    for i in range(2))
            qkv = torch.stack([q, k, qkv4[:, 2]], dim=1).reshape(n, -1)
        rpe = None
        if hasattr(self, "rpe"):
            rpe = (self.rpe.rpe_table, grid_coord[slot_to_point.idx])
        out = patch_attention(qkv, slot_to_point, point_to_slot,
                              num_heads=self.num_heads, patch_size=self.patch_size,
                              scale=self.scale, rpe=rpe)
        return self.proj(out)


class LayerScale(nn.Module):
    """A learned per-channel gain (reference name: gamma), made at
    `init_value`."""

    def __init__(self, channels: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((channels,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """xCPE + attention + MLP with residuals (reference names: cpe.{0,1,2},
    norm1.0, attn.{qkv,proj}, norm2.0, mlp.0.{fc1,fc2}; with `layer_scale`,
    ls1.0.gamma and ls2.0.gamma scale the attention and MLP branches)."""

    def __init__(self, channels, num_heads, patch_size, mlp_ratio=4.0, qkv_bias=True,
                 qk_scale=None, pre_norm=True, compute_dtype=None, drop_path=0.0, fused=False,
                 layer_scale=None, rope=None, lora_rank=0, pd=None, enable_rpe=False):
        super().__init__()
        c = channels
        self.pre_norm = pre_norm
        self.drop_path = DropPath(drop_path)
        if layer_scale is not None:
            self.ls1 = nn.ModuleList([LayerScale(c, layer_scale)])
            self.ls2 = nn.ModuleList([LayerScale(c, layer_scale)])
        self.cpe = nn.ModuleList([
            SubMConv(c, c, 3, bias=True, fused=fused), Linear(c, c, compute_dtype=compute_dtype),
            make_norm("ln", c, pd),
        ])
        self.norm1 = nn.ModuleList([make_norm("ln", c, pd)])
        self.attn = SerializedAttention(c, num_heads, patch_size, qkv_bias, qk_scale, compute_dtype, rope,
                                        lora_rank, enable_rpe)
        self.norm2 = nn.ModuleList([make_norm("ln", c, pd)])
        self.mlp = nn.ModuleList([MLP(c, int(c * mlp_ratio), c, compute_dtype=compute_dtype)])

    def forward(self, pb: PointBatch, nbr3, partition, cpe_feat=None,
                generator: Optional[torch.Generator] = None) -> PointBatch:
        # `cpe_feat`: the first decoder block's conv reads the skip branch
        # alone. The reference never re-syncs its sparse-conv feature after
        # unpooling, and trained weights depend on that.
        feat = pb.feat
        cpe = self.cpe[0](feat if cpe_feat is None else cpe_feat, nbr3)
        feat = feat + apply_norm(self.cpe[2], self.cpe[1](cpe), pb)
        x = apply_norm(self.norm1[0], feat, pb) if self.pre_norm else feat
        feat = feat + self.drop_path(self._scale("ls1", self.attn(x, partition, pb.coord, generator, pb.grid_coord)),
                                     generator)
        if not self.pre_norm:
            feat = apply_norm(self.norm1[0], feat, pb)
        x = apply_norm(self.norm2[0], feat, pb) if self.pre_norm else feat
        feat = feat + self.drop_path(self._scale("ls2", self.mlp[0](x)), generator)
        if not self.pre_norm:
            feat = apply_norm(self.norm2[0], feat, pb)
        return pb.replace(feat=feat)

    def _scale(self, name: str, x: torch.Tensor) -> torch.Tensor:
        ls = getattr(self, name, None)
        return x if ls is None else ls[0](x)


def pooling_geometry(pb: PointBatch, stride: int, out_capacity: int, orders, needed,
                     identity_order0: bool) -> dict:
    """Feature-independent half of SerializedPooling: clusters are runs of
    equal shifted order-0 keys in order-0 sorted order (`identity_order0`:
    the batch already is in that order). With `needed` (unshuffled orders)
    the pooled keys of those orders are re-encoded from the pooled grid
    (curve codes are hierarchical); without it (shuffled orders) every
    order's pooled keys are the shifted keys of each cluster's head point.
    Pooled order 0 is already sorted."""
    dev = pb.device
    pdepth = stride.bit_length() - 1
    bits = 3 * pdepth
    m = out_capacity
    n = pb.capacity
    s = pb.serialized_keys.shape[0]
    reencode = needed is not None
    order0, inverse0 = pb.serialized_order[0].long(), pb.serialized_inverse[0].long()
    shifted = None
    if reencode:
        shifted0 = ser.key_shift_right(pb.serialized_keys[0], bits)
    else:
        shifted = torch.stack([ser.key_shift_right(pb.serialized_keys[i], bits) for i in range(s)])
        shifted0 = shifted[0]
    if identity_order0:
        sk, valid = shifted0, pb.mask
    else:
        sk, valid = shifted0[order0], pb.mask[order0]
    prev_eq = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), ser.keys_equal(sk[1:], sk[:-1])])
    head = valid & ~prev_eq
    cluster = (torch.cumsum(head.to(torch.int32), 0) - 1).to(torch.int32)
    ok = valid & (cluster < m)
    seg_ids = torch.where(ok, cluster, m)
    overflow = (valid & (cluster >= m)).sum().to(torch.int32)
    cluster_of_point = seg_ids if identity_order0 else seg_ids[inverse0]

    # each cluster's head position, without host syncs (see build_block_tables)
    is_head = head & ok
    tgt = torch.where(is_head, cluster, m).long()
    hsel = torch.zeros(m + 1, dtype=torch.long, device=dev).scatter_(
        0, tgt, torch.arange(n, device=dev))[:m]
    head_valid = torch.arange(m, device=dev) < is_head.sum()
    head_point = hsel if identity_order0 else order0[hsel]
    grid = torch.where(head_valid[:, None], pb.grid_coord[head_point] >> pdepth, 0)
    batch = torch.where(head_valid, pb.batch[head_point], -1)
    segment = None if pb.segment is None else torch.where(head_valid, pb.segment[head_point], -1)

    depth = pb.serialized_depth - pdepth
    iota = torch.arange(m, dtype=torch.int32, device=dev)
    keys, order, inverse = [], [], []
    if reencode:
        kb = torch.where(batch >= 0, batch, ser.BATCH_SENTINEL).to(torch.int32)
        k0 = ser.encode(grid, kb, depth, orders[0])
    else:
        sentinel = torch.zeros(3, dtype=torch.int32, device=dev)
        sentinel[0] = ser.BATCH_SENTINEL
    for i in range(s):
        if not reencode:
            keys.append(torch.where(head_valid[:, None], shifted[i][head_point], sentinel))
        else:
            keys.append(ser.encode(grid, kb, depth, orders[i]) if (i != 0 and i in needed) else k0)
        if i == 0 or (reencode and i not in needed):
            order.append(iota)
            inverse.append(iota)
        else:
            o = ser.argsort_keys(keys[i], depth)
            order.append(o)
            inverse.append(ser.invert_order(o))
    return dict(seg_ids=seg_ids, cluster_of_point=cluster_of_point, overflow=overflow, grid=grid,
                batch=batch, segment=segment, keys=torch.stack(keys), order=torch.stack(order),
                inverse=torch.stack(inverse), depth=depth)


class SerializedPooling(nn.Module):
    """Grid pooling by shifted curve codes into a static `out_capacity`
    (clusters beyond it are dropped and counted). Names: proj, norm.0."""

    def __init__(self, in_channels, out_channels, stride=2, compute_dtype=None, pd=None):
        super().__init__()
        self.stride = stride
        self.proj = Linear(in_channels, out_channels, compute_dtype=compute_dtype)
        self.norm = nn.ModuleList([make_norm("bn", out_channels, pd)])

    def forward(self, pb: PointBatch, out_capacity: int, orders, needed, identity_order0: bool,
                generator: Optional[torch.Generator] = None, geom: Optional[dict] = None):
        """`generator`: shuffle the pooled batch's orders (the shuffled route).
        `geom`: the `pooling_geometry` of this batch, built beforehand."""
        g = geom if geom is not None else pooling_geometry(pb, self.stride, out_capacity, orders, needed,
                                                           identity_order0)
        m = out_capacity
        proj, coord, origin = self.proj(pb.feat), pb.coord, pb.origin_coord
        if not identity_order0:
            # reduce in the sorted layout: cluster ids are non-decreasing there
            order0 = pb.serialized_order[0].long()
            proj, coord = proj[order0], coord[order0]
            origin = None if origin is None else origin[order0]
        feat = segment_reduce(proj, g["seg_ids"], m, reduce="max")
        coord = sorted_segment_mean(coord, g["seg_ids"], m)
        origin = None if origin is None else sorted_segment_mean(origin, g["seg_ids"], m)
        out = PointBatch(
            coord=coord, feat=feat, grid_coord=g["grid"], batch=g["batch"],
            segment=g["segment"], serialized_keys=g["keys"], serialized_order=g["order"],
            serialized_inverse=g["inverse"], serialized_depth=g["depth"],
            num_scenes=pb.num_scenes, origin_coord=origin, condition=pb.condition, context=pb.context,
        )
        out = out.replace(feat=gelu(apply_norm(self.norm[0], feat, out, out.mask)))
        if generator is not None:
            out = out.shuffle_orders_(generator)
        return out, g["cluster_of_point"], g["overflow"]


class SerializedUnpooling(nn.Module):
    """proj + skip add by cluster. Names: proj.{0,1}, proj_skip.{0,1}."""

    def __init__(self, in_channels, skip_channels, out_channels, compute_dtype=None, pd=None):
        super().__init__()
        self.proj = nn.ModuleList([
            Linear(in_channels, out_channels, compute_dtype=compute_dtype), make_norm("bn", out_channels, pd)
        ])
        self.proj_skip = nn.ModuleList([
            Linear(skip_channels, out_channels, compute_dtype=compute_dtype),
            make_norm("bn", out_channels, pd),
        ])

    def forward(self, pb: PointBatch, skip_pb: PointBatch, cluster: torch.Tensor):
        m = pb.capacity
        x = gelu(apply_norm(self.proj[1], self.proj[0](pb.feat), pb, pb.mask))
        skip = gelu(apply_norm(self.proj_skip[1], self.proj_skip[0](skip_pb.feat), skip_pb, skip_pb.mask))
        up = x[torch.clamp(cluster, max=m - 1).long()]
        up = torch.where((cluster < m)[:, None], up, torch.zeros((), dtype=up.dtype, device=up.device))
        # the second output, the skip branch alone, feeds the next block's cpe
        return skip_pb.replace(feat=skip + up), skip


class Embedding(nn.Module):
    """The stem. ``mode="conv"``: SubM k5 conv + BN + GELU (names stem.conv,
    stem.norm); ``mode="linear"`` (PT-v3m2): Linear + LayerNorm + GELU
    (stem.linear, stem.norm). With `mask_token`, a learned row (made at 0)
    replaces the features of the points of the caller's `patch_mask`."""

    def __init__(self, in_channels, embed_channels, fused=False, mode="conv", mask_token=False,
                 compute_dtype=None, pd=None):
        super().__init__()
        if mode not in ("conv", "linear"):
            raise NotImplementedError(f"Embedding: mode {mode!r} is not ported")
        self.mode = mode
        self.in_channels = in_channels
        self.stem = nn.Module()
        if mode == "conv":
            self.stem.conv = SubMConv(in_channels, embed_channels, 5, bias=False, fused=fused)
            self.stem.norm = make_norm("bn", embed_channels, pd)
        else:
            self.stem.linear = Linear(in_channels, embed_channels, compute_dtype=compute_dtype)
            self.stem.norm = make_norm("ln", embed_channels, pd)
        self.mask_token = nn.Parameter(torch.zeros(1, embed_channels)) if mask_token else None

    def forward(self, pb: PointBatch, nbr5, patch_mask: Optional[torch.Tensor] = None) -> PointBatch:
        if pb.feat.shape[1] != self.in_channels:
            # the JAX package's stems infer their width; a config's in_channels
            # that differs from its data (Utonia's 9 over ScanNet's 6) is refused here
            raise ValueError(f"PT-v3 stem: in_channels={self.in_channels} but the batch's features have "
                             f"{pb.feat.shape[1]} channels")
        if self.mode == "conv":
            feat = gelu(apply_norm(self.stem.norm, self.stem.conv(pb.feat, nbr5), pb, pb.mask))
        else:
            feat = gelu(apply_norm(self.stem.norm, self.stem.linear(pb.feat), pb))
        if self.mask_token is not None and patch_mask is not None:
            feat = torch.where(patch_mask[:, None], self.mask_token.to(feat.dtype), feat)
        return pb.replace(feat=feat)


def up_cast(pb: PointBatch, skips: list, levels: int) -> PointBatch:
    """An enc_mode backbone's output with the features of `levels` earlier
    stages of its skip chain, deepest first: at each level every point of
    the finer stage puts its own features first and its cluster's features
    of the coarser stage after them (zero where its cluster was dropped)."""
    feat = pb.feat
    skips = list(skips)
    for _ in range(min(levels, len(skips))):
        skip_pb, cluster, _ctx = skips.pop()
        m = feat.shape[0]
        up = feat[torch.clamp(cluster, max=m - 1).long()]
        up = torch.where((cluster < m)[:, None], up, torch.zeros((), dtype=up.dtype, device=up.device))
        feat = torch.cat([skip_pb.feat, up], dim=-1)
        pb = skip_pb.replace(feat=feat)
    return pb


_UNSUPPORTED = dict(scene_blocked=False, attn_drop=0.0, proj_drop=0.0)


@MODELS.register_module("PT-v3m1")
class PointTransformerV3(nn.Module):
    """PT-v3m1 backbone; `forward(pb, generator)` returns (decoded PointBatch
    in the caller's point order, diagnostics), and with `enc_mode` (the last
    stage's PointBatch, diagnostics, skips). The diagnostics count the
    points dropped by static capacities: ``block_overflow`` (one per
    block-table build) and ``pool_overflow`` (one per pooling). In train mode
    the order shuffles and drop-path masks are drawn from `generator`."""

    default_embed_mode = "conv"
    takes_rope = False  # RoPE is PT-v3m3's (the Utonia configs')

    def __init__(
        self,
        in_channels: int = 6,
        order: Sequence[str] = ("z", "z-trans", "hilbert", "hilbert-trans"),
        stride: Sequence[int] = (2, 2, 2, 2),
        enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
        enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
        enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
        enc_patch_size: Sequence[int] = (1024, 1024, 1024, 1024, 1024),
        dec_depths: Sequence[int] = (2, 2, 2, 2),
        dec_channels: Sequence[int] = (64, 64, 128, 256),
        dec_num_head: Sequence[int] = (4, 4, 8, 16),
        dec_patch_size: Sequence[int] = (1024, 1024, 1024, 1024),
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        drop_path: float = 0.3,
        pre_norm: bool = True,
        shuffle_orders: bool = True,
        serialize_depth: int = 12,
        pool_capacity_factors: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
        conv_engine: str = "gather",
        block_capacity_factor=1.0 / 16.0,
        block_bits: int = 3,
        sorted_layout: bool = True,
        block_engine_min_points: int = 8192,
        block_conv_fused: bool = False,
        grid_size: float = 0.02,
        amp: bool = False,
        enc_mode: bool = False,
        embed_mode: Optional[str] = None,
        mask_token: bool = False,
        layer_scale: Optional[float] = None,
        lora_rank: int = 0,
        pdnorm_bn: bool = False,
        pdnorm_ln: bool = False,
        pdnorm_decouple: bool = True,
        pdnorm_adaptive: bool = False,
        pdnorm_conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D"),
        # config-parity options without effect (attention is always fused,
        # its softmax always f32; the norms are always affine, as in the JAX package)
        enable_flash: bool = True,
        upcast_attention: bool = False,
        upcast_softmax: bool = False,
        pdnorm_affine: bool = True,
        rope_base: Optional[float] = None,
        shift_coords: Optional[float] = None,
        jitter_coords: Optional[float] = None,
        rescale_coords: Optional[float] = None,
        enable_rpe: bool = False,
        **unsupported,
    ):
        super().__init__()
        if enable_rpe and unsupported.get("scene_blocked"):
            # the JAX package asserts it: "window attention has no RPE path"
            raise NotImplementedError(f"{type(self).__name__}: window attention (scene_blocked) has no RPE path")
        for key, value in unsupported.items():
            if key not in _UNSUPPORTED:
                raise TypeError(f"{type(self).__name__}: unexpected argument {key!r}")
            if value != _UNSUPPORTED[key]:
                raise NotImplementedError(f"{type(self).__name__}: {key}={value!r} is not ported yet")
        self.enc_mode = enc_mode
        embed_mode = embed_mode or self.default_embed_mode
        self.embed_mode = embed_mode
        self.enc_channels = tuple(enc_channels)
        if enc_mode:
            dec_depths = dec_channels = dec_num_head = dec_patch_size = ()
        rope = None
        if rope_base and not self.takes_rope:
            raise NotImplementedError(f"{type(self).__name__}: rope_base is ported for PT-v3m3 only")
        if rope_base:
            rope = dict(base=float(rope_base), shift=shift_coords, jitter=jitter_coords, rescale=rescale_coords)
            for c, h in zip(tuple(enc_channels) + tuple(dec_channels), tuple(enc_num_head) + tuple(dec_num_head)):
                if c % h != 0 or (c // h) % 6 != 0:
                    raise ValueError(f"{type(self).__name__}: RoPE needs head dims that are multiples of 6, "
                                     f"got {c}/{h}")
        self.rope = rope
        self.order = (order,) if isinstance(order, str) else tuple(order)
        self.stride = tuple(stride)
        self.enc_depths = tuple(enc_depths)
        self.dec_depths = tuple(dec_depths)
        self.enc_patch_size = tuple(enc_patch_size)
        self.dec_patch_size = tuple(dec_patch_size)
        self.drop_path = drop_path
        self.shuffle_orders = shuffle_orders
        self.serialize_depth = serialize_depth
        self.pool_capacity_factors = tuple(pool_capacity_factors)
        self.conv_engine = conv_engine
        self.block_capacity_factor = block_capacity_factor
        self.block_bits = block_bits
        self.sorted_layout = sorted_layout
        self.block_engine_min_points = block_engine_min_points
        self.grid_size = grid_size
        self.amp = amp
        dt = torch.bfloat16 if amp else None
        n = len(enc_depths)
        # drop-path schedule (reference): a linspace over the encoder depths;
        # each decoder stage takes its slice of a linspace, reversed
        enc_dp = np.linspace(0, drop_path, sum(enc_depths)).tolist()
        dec_dp = np.linspace(0, drop_path, sum(dec_depths)).tolist()

        fused = block_conv_fused
        pd = None
        if pdnorm_bn or pdnorm_ln:
            pd = dict(bn=pdnorm_bn, ln=pdnorm_ln, conditions=tuple(pdnorm_conditions), decouple=pdnorm_decouple,
                      adaptive=pdnorm_adaptive)
        self.embedding = Embedding(in_channels, enc_channels[0], fused, embed_mode, mask_token, dt, pd)
        self.enc = nn.Module()
        for s in range(n):
            stage = nn.Module()
            if s > 0:
                stage.down = SerializedPooling(enc_channels[s - 1], enc_channels[s],
                                               stride=stride[s - 1], compute_dtype=dt, pd=pd)
            for i in range(enc_depths[s]):
                stage.add_module(f"block{i}", Block(
                    enc_channels[s], enc_num_head[s], enc_patch_size[s], mlp_ratio, qkv_bias,
                    qk_scale, pre_norm, dt, drop_path=enc_dp[sum(enc_depths[:s]) + i], fused=fused,
                    layer_scale=layer_scale, rope=rope, lora_rank=lora_rank, pd=pd, enable_rpe=enable_rpe,
                ))
            self.enc.add_module(f"enc{s}", stage)
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        self.dec = nn.Module()
        for s in reversed(range(0 if enc_mode else n - 1)):
            stage = nn.Module()
            stage.up = SerializedUnpooling(dec_ch[s + 1], enc_channels[s], dec_ch[s], compute_dtype=dt, pd=pd)
            dp_slice = dec_dp[sum(dec_depths[:s]) : sum(dec_depths[: s + 1])][::-1]
            for i in range(dec_depths[s]):
                stage.add_module(f"block{i}", Block(
                    dec_ch[s], dec_num_head[s], dec_patch_size[s], mlp_ratio, qkv_bias,
                    qk_scale, pre_norm, dt, drop_path=dp_slice[i], fused=fused,
                    layer_scale=layer_scale, rope=rope, lora_rank=lora_rank, pd=pd, enable_rpe=enable_rpe,
                ))
            self.dec.add_module(f"dec{s}", stage)
        self.out_channels = enc_channels[-1] if enc_mode else dec_ch[0]

    def _used_orders(self, stage: int, shuffled: bool):
        """Orders the blocks of a stage read (with shuffled orders: all)."""
        s_orders = len(self.order)
        if shuffled:
            return tuple(range(s_orders))
        used = {0} | {i % s_orders for i in range(self.enc_depths[stage])}
        if stage < len(self.dec_depths):
            used |= {i % s_orders for i in range(self.dec_depths[stage])}
        return tuple(sorted(used))

    def _block_tables(self, pb: PointBatch, stage: int, diag: dict, shuffled: bool,
                      ident0: bool) -> dict:
        f = self.block_capacity_factor
        if isinstance(f, (tuple, list)):
            f = f[min(stage, len(f) - 1)]
        # with shuffled orders order 0 may be any curve: the tables re-sort by z
        curve_is_z = not shuffled and self.order[0] == "z"
        t = build_block_tables(
            pb.serialized_keys[0], pb.serialized_order[0], pb.grid_coord, pb.mask,
            pb.serialized_depth, default_block_capacity(pb.capacity, f),
            block_bits=self.block_bits, inverse0=pb.serialized_inverse[0],
            curve_is_z=curve_is_z, identity_order0=curve_is_z and ident0,
        )
        diag["block_overflow"].append(t["overflow"])
        return t

    def _stage_ctx(self, pb: PointBatch, stage: int, patch_size: int, nbr5, stage0_tables, diag,
                   shuffled: bool, ident0: bool, depth: int):
        if self.conv_engine == "block" and pb.capacity >= self.block_engine_min_points:
            nbr3 = (stage0_tables if stage == 0 and stage0_tables is not None
                    else self._block_tables(pb, stage, diag, shuffled, ident0))
        elif stage == 0 and nbr5 is not None and not isinstance(nbr5, dict):
            # the stage-0 k3 map is a column subset of the stem's k5 map
            nbr3 = nbr5[:, torch.as_tensor(k3_columns_of_k5(), device=pb.device).long()]
        else:
            nbr3 = build_subm_neighbor_map(pb.grid_coord, pb.key_batch(), pb.mask, depth - stage, 3)
        parts = patch_runs({oi: pb.patch_partition(oi, patch_size) for oi in self._used_orders(stage, shuffled)})
        return dict(nbr3=nbr3, parts=parts)

    def _pooled_capacity(self, cap: int, stage: int) -> int:
        return _round_up(max(int(math.ceil(cap * self.pool_capacity_factors[stage - 1])), 128), 128)

    def build_geometry(self, pb: PointBatch) -> dict:
        """The feature-independent half of the eval forward, built once for
        every batch of `pb`'s points (grid, batch ids; features ignored):
        the template batch ``pb0`` (serialized, pinned to order 0), the pin
        ``perm0`` and its ``unsort`` pair, the stem's tables ``nbr5``, each
        stage's context (conv tables or rule map, patch partitions) and each
        pooling's geometry, and ``overflow``: the points the static
        capacities dropped, summed. Eval mode only (train mode shuffles the
        orders and draws drop-path masks)."""
        if self.training:
            raise ValueError("PT-v3m1: build_geometry serves the eval forward; the model is in train mode")
        if self.enc_mode:
            raise ValueError("PT-v3: build_geometry serves the eval forward of the decoder path, not enc_mode")
        num_stages = len(self.enc_depths)
        diag = {"block_overflow": [], "pool_overflow": []}
        pb = pb.with_grid_coord(self.grid_size).replace(feat=None)
        depth = serialization_depth(self.serialize_depth, pb)
        used0 = self._used_orders(0, False)
        pb = pb.serialize(orders=self.order, depth=depth, sort_indices=used0, key_orders=used0)
        perm0 = unsort = None
        if self.sorted_layout:
            perm0, inv0 = pb.serialized_order[0], pb.serialized_inverse[0]
            pb = pb.reorder(perm0, inv0, rebase_orders=used0, rebase_keys=used0)
            unsort = (inv0, perm0)
        stage0_tables = None
        if self.conv_engine == "block":
            stage0_tables = nbr5 = self._block_tables(pb, 0, diag, False, self.sorted_layout)
        else:
            nbr5 = build_subm_neighbor_map(pb.grid_coord, pb.key_batch(), pb.mask, depth, 5)
        pb0, stages, pools = pb, [], []
        cap = pb.capacity
        for s in range(num_stages):
            if s > 0:
                cap = self._pooled_capacity(cap, s)
                g = pooling_geometry(pb, self.stride[s - 1], cap, self.order, self._used_orders(s, False),
                                     identity_order0=s > 1 or self.sorted_layout)
                diag["pool_overflow"].append(g["overflow"])
                pools.append(g)
                pb = PointBatch(
                    coord=torch.zeros((cap, 3), dtype=torch.float32, device=pb.device), feat=None,
                    grid_coord=g["grid"], batch=g["batch"], segment=g["segment"], serialized_keys=g["keys"],
                    serialized_order=g["order"], serialized_inverse=g["inverse"],
                    serialized_depth=g["depth"], num_scenes=pb.num_scenes,
                )
            stages.append(self._stage_ctx(pb, s, self.enc_patch_size[s], nbr5, stage0_tables, diag, False,
                                          s > 0 or self.sorted_layout, depth))
        overflow = torch.zeros((), dtype=torch.int32, device=pb.device)
        for v in (v for vs in diag.values() for v in vs):
            overflow = overflow + v
        return dict(pb0=pb0, perm0=perm0, unsort=unsort, nbr5=nbr5, stages=stages, pools=pools,
                    overflow=overflow)

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None,
                precomputed: Optional[dict] = None, patch_mask: Optional[torch.Tensor] = None):
        """`precomputed`: the `build_geometry` of a batch of the same points
        (grid and batch ids); `pb` then brings only its features (and
        coords), which go through the geometry's pin. Its overflow is counted
        once, as ``geom_overflow``. `patch_mask` [N] bool: the points whose
        stem features the mask token replaces (``mask_token`` only)."""
        s_orders = len(self.order)
        num_stages = len(self.enc_depths)
        shuffled = self.training and self.shuffle_orders
        if generator is None and self.training and (shuffled or self.drop_path > 0):
            raise ValueError("PT-v3m1: train mode draws its order shuffles and drop-path masks "
                             "from an explicit generator")
        if self.amp:
            pb = pb.replace(feat=pb.feat.to(torch.bfloat16))
        diag = {"block_overflow": [], "pool_overflow": []}
        geom = precomputed
        if geom is not None:
            if self.training:
                raise ValueError("PT-v3m1: a precomputed geometry serves the eval forward only")
            diag["geom_overflow"] = [geom["overflow"]]
            feat, coord, segment = pb.feat, pb.coord, pb.segment
            if geom["perm0"] is not None:
                p = geom["perm0"].long()
                feat, coord = feat[p], coord[p]
                segment = None if segment is None else segment[p]
            pb = geom["pb0"].replace(feat=feat, coord=coord, segment=segment, condition=pb.condition,
                                     context=pb.context)
            sorted_ok, unsort, nbr5 = self.sorted_layout, geom["unsort"], geom["nbr5"]
        else:
            pb = pb.with_grid_coord(self.grid_size)
            depth = serialization_depth(self.serialize_depth, pb)
            if shuffled:
                pb = pb.serialize(orders=self.order, depth=depth, generator=generator)
            else:
                used0 = self._used_orders(0, False)
                pb = pb.serialize(orders=self.order, depth=depth, sort_indices=used0, key_orders=used0)
            # enc_mode keeps the caller's order: its skips are read by point
            sorted_ok = self.sorted_layout and not shuffled and not self.enc_mode
            unsort = None
            if sorted_ok:
                # sorted layout: pin the batch to order 0, which then is the identity
                perm0, inv0 = pb.serialized_order[0], pb.serialized_inverse[0]
                pb = pb.reorder(perm0, inv0, rebase_orders=used0, rebase_keys=used0)
                unsort = (inv0, perm0)
                if patch_mask is not None:
                    patch_mask = patch_mask[perm0.long()]

        def ident0(stage):
            # order 0 is the identity: at stage 0 after the pin, at pooled
            # stages whenever the orders are unshuffled (pooling's output order)
            return not shuffled and (stage > 0 or sorted_ok)

        if geom is None:
            stage0_tables = nbr5 = None
            if self.conv_engine == "block":
                # the stem's and stage 0's tables (a linear stem needs none)
                stage0_tables = nbr5 = self._block_tables(pb, 0, diag, shuffled, ident0(0))
            elif self.embed_mode == "conv":
                nbr5 = build_subm_neighbor_map(pb.grid_coord, pb.key_batch(), pb.mask, depth, 5)
        pb = self.embedding(pb, nbr5, patch_mask)

        skips = []
        ctx = None
        cap = pb.capacity
        for s in range(num_stages):
            stage = getattr(self.enc, f"enc{s}")
            if s > 0:
                cap = self._pooled_capacity(cap, s)
                skip_pb = pb
                pb, cluster, overflow = stage.down(
                    pb, cap, self.order, None if shuffled else self._used_orders(s, False),
                    ident0(s - 1), generator if shuffled else None,
                    geom=None if geom is None else geom["pools"][s - 1],
                )
                if geom is None:
                    diag["pool_overflow"].append(overflow)
                skips.append((skip_pb, cluster, ctx))
            ctx = (geom["stages"][s] if geom is not None
                   else self._stage_ctx(pb, s, self.enc_patch_size[s], nbr5, stage0_tables, diag,
                                        shuffled, ident0(s), depth))
            for i in range(self.enc_depths[s]):
                pb = getattr(stage, f"block{i}")(pb, ctx["nbr3"], ctx["parts"][i % s_orders],
                                                 generator=generator)
        if self.enc_mode:
            return pb, diag, skips

        for s in reversed(range(num_stages - 1)):
            stage = getattr(self.dec, f"dec{s}")
            skip_pb, cluster, skip_ctx = skips[s]
            pb, stale_cpe_feat = stage.up(pb, skip_pb, cluster)
            for i in range(self.dec_depths[s]):
                pb = getattr(stage, f"block{i}")(
                    pb, skip_ctx["nbr3"], skip_ctx["parts"][i % s_orders],
                    cpe_feat=stale_cpe_feat if i == 0 else None, generator=generator,
                )
        if unsort is not None:
            # restore the caller's point order
            pb = pb.reorder(unsort[0], unsort[1], rebase_orders=(), rebase_keys=False)
        pb = pb.replace(serialized_keys=None, serialized_order=None, serialized_inverse=None)
        return pb, diag


@MODELS.register_module("PT-v3m2")
class PointTransformerV3M2(PointTransformerV3):
    """The Sonata variant (reference point_transformer_v3m2_sonata.py):
    PT-v3m1 with the linear stem by default, the optional mask token and
    LayerScale."""

    default_embed_mode = "linear"


@MODELS.register_module("PT-v3m3")
class PointTransformerV3M3(PointTransformerV3M2):
    """The Utonia variant (reference point_transformer_v3m3_utonia.py):
    PT-v3m2 with 3D RoPE on q and k (``rope_base``, 10000 unless the config
    says otherwise) and the optional train-time shift, jitter and rescale of
    the RoPE positions."""

    takes_rope = True

    def __init__(self, rope_base: Optional[float] = 10000.0, **kwargs):
        super().__init__(rope_base=rope_base, **kwargs)
