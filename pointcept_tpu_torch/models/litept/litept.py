"""LitePT-v1 (counterpart of `pointcept_tpu/models/litept/litept.py`;
reference `pointcept/models/litept/litept_v1.py`).

A PT-v3-style serialized U-Net whose early stages are conv-only (SubM k3
with bias on the gather engine) and whose deep stages are attention-only,
with 3D rotary position embedding (PointROPE) on the integer grid
coordinates in place of xCPE; decoder stages default to depth 0 (pure
unpooling). The stem (SubM k5 + BN + GELU), the max-pooling
`SerializedPooling` and the `SerializedUnpooling` are PT-v3's.

The attention rotates q and k by each point's stage `grid_coord` at the
stage's `rope_freq` (`ops/pointrope.py`) before the slot gather, then runs
the patch-attention kernels (head dim 18 at the class defaults, on heads
zero-padded to 24). The JAX package computes that attention densely.

Each stage builds its neighbour map only where a conv of its encoder or
decoder blocks needs it, and its patch partitions only where an attention
does; a decoder stage reuses its encoder stage's (`litept.py:236`). In
train mode the order shuffles and drop-path masks are drawn from the
caller's generator. The class takes no `amp` (nor does the JAX one), so a
config's ``enable_amp`` leaves its stream in f32; the attention's operands
are bf16.

Parameter names: PT-v3's for the shared pieces (``embedding.stem.*``,
``enc.enc{s}.down.*``, ``enc.enc{s}.block{i}.*``, ``dec.dec{s}.up.*``) and
the JAX package's for LitePT's own (``norm0``, ``conv``, ``norm1``,
``attn.{qkv,proj}``, ``norm2``, ``mlp.{fc1,fc2}``): the reference's
`litept_v1.py` is not in the repository to check them against.

Not ported: attention and projection dropout (no config names them).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...ops.attention import patch_attention, patch_runs
from ...ops.pointrope import point_rope
from ...ops.sparse_conv import build_subm_neighbor_map, k3_columns_of_k5
from ..builder import MODELS
from ..modules import MLP, DropPath, LayerNorm, Linear
from ..point_transformer_v3.point_transformer_v3 import (
    Embedding, SerializedPooling, SerializedUnpooling, SubMConv, _round_up,
)
from ..utils.structure import PointBatch, serialization_depth


class PointROPEAttention(nn.Module):
    """qkv projection, PointROPE on q and k at the points' grid
    coordinates, patch attention on the kernels, output projection (names
    qkv, proj)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int, rope_freq: float = 100.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.rope_freq = float(rope_freq)
        self.scale = qk_scale or (channels // num_heads) ** -0.5
        self.qkv = Linear(channels, 3 * channels, bias=qkv_bias)
        self.proj = Linear(channels, channels)

    def forward(self, feat: torch.Tensor, grid_coord: torch.Tensor, partition) -> torch.Tensor:
        slot_to_point, point_to_slot = partition
        n, h = feat.shape[0], self.num_heads
        qkv4 = self.qkv(feat).reshape(n, 3, h, -1)
        q, k = (point_rope(qkv4[:, i].transpose(0, 1), grid_coord, freq=self.rope_freq).transpose(0, 1)
                for i in range(2))
        qkv = torch.stack([q, k, qkv4[:, 2]], dim=1).reshape(n, -1)
        out = patch_attention(qkv, slot_to_point, point_to_slot, num_heads=h, patch_size=self.patch_size,
                              scale=self.scale)
        return self.proj(out)


class LitePTBlock(nn.Module):
    """An optional conv branch (norm0, conv: SubM k3 with bias), an optional
    attention branch (norm1, attn), then the MLP (norm2, mlp), each a
    pre-norm residual with its own drop-path mask. Without `pre_norm` the
    branches read the stream unnormalised and no norm is made, as in the
    JAX package."""

    def __init__(self, channels, num_heads, patch_size, rope_freq=100.0, mlp_ratio=4.0, qkv_bias=True,
                 qk_scale=None, drop_path=0.0, pre_norm=True, enable_conv=True, enable_attn=False):
        super().__init__()
        c = channels
        self.pre_norm = pre_norm
        self.drop_path = DropPath(drop_path)
        if enable_conv:
            if pre_norm:
                self.norm0 = LayerNorm(c)
            self.conv = SubMConv(c, c, 3, bias=True)
        if enable_attn:
            if pre_norm:
                self.norm1 = LayerNorm(c)
            self.attn = PointROPEAttention(c, num_heads, patch_size, rope_freq, qkv_bias, qk_scale)
        if pre_norm:
            self.norm2 = LayerNorm(c)
        self.mlp = MLP(c, int(c * mlp_ratio), c)

    def _norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(x) if self.pre_norm else x

    def forward(self, pb: PointBatch, nbr3, partition, generator: Optional[torch.Generator] = None) -> PointBatch:
        feat = pb.feat
        if hasattr(self, "conv"):
            feat = feat + self.drop_path(self.conv(self._norm("norm0", feat), nbr3), generator)
        if hasattr(self, "attn"):
            feat = feat + self.drop_path(self.attn(self._norm("norm1", feat), pb.grid_coord, partition), generator)
        feat = feat + self.drop_path(self.mlp(self._norm("norm2", feat)), generator)
        return pb.replace(feat=feat)


@MODELS.register_module("LitePT-v1")
class LitePT(nn.Module):
    """LitePT-v1 backbone; `forward(pb, generator)` returns (the decoded
    PointBatch in the caller's point order, diagnostics), and with
    `enc_mode` (the last stage's PointBatch, diagnostics, skips). The
    diagnostics count the points each pooling dropped (``pool_overflow``),
    beside an empty ``block_overflow`` (no block engine)."""

    def __init__(
        self,
        in_channels: int = 4,
        order: Sequence[str] = ("z", "z-trans", "hilbert", "hilbert-trans"),
        stride: Sequence[int] = (2, 2, 2, 2),
        enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
        enc_channels: Sequence[int] = (36, 72, 144, 252, 504),
        enc_num_head: Sequence[int] = (2, 4, 8, 14, 28),
        enc_patch_size: Sequence[int] = (1024, 1024, 1024, 1024, 1024),
        enc_conv: Sequence[bool] = (True, True, True, False, False),
        enc_attn: Sequence[bool] = (False, False, False, True, True),
        enc_rope_freq: Sequence[float] = (100.0,) * 5,
        dec_depths: Sequence[int] = (0, 0, 0, 0),
        dec_channels: Sequence[int] = (72, 72, 144, 252),
        dec_num_head: Sequence[int] = (4, 4, 8, 14),
        dec_patch_size: Sequence[int] = (1024, 1024, 1024, 1024),
        dec_conv: Sequence[bool] = (False, False, False, False),
        dec_attn: Sequence[bool] = (False, False, False, False),
        dec_rope_freq: Sequence[float] = (100.0,) * 4,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
        drop_path: float = 0.3,
        pre_norm: bool = True,
        shuffle_orders: bool = True,
        enc_mode: bool = False,
        serialize_depth: int = 12,
        pool_capacity_factors: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
        grid_size: float = 0.02,
        **unexpected,
    ):
        super().__init__()
        n = len(enc_depths)
        if enc_mode:
            dec_depths = ()
        attn_stages = [("enc", s, c, h) for s, (c, h, a, dd) in enumerate(
            zip(enc_channels, enc_num_head, enc_attn, enc_depths)) if a and dd > 0]
        attn_stages += [("dec", s, c, h) for s, (c, h, a, dd) in enumerate(
            zip(dec_channels, dec_num_head, dec_attn, dec_depths)) if a and dd > 0]
        bad = [f"{kind}{s}: {c}/{h}" + ("" if c % h else f" = {c // h}")
               for kind, s, c, h in attn_stages if c % h != 0 or (c // h) % 6 != 0]
        if unexpected:
            # the LitePT configs name `patch_size`, which the class (JAX's too) does not take
            msg = f"LitePT-v1: unexpected argument(s) {sorted(unexpected)}"
            if "patch_size" in unexpected:
                msg += ("; the LitePT configs name patch_size, which LitePT-v1 does not take "
                        "(enc_patch_size / dec_patch_size)")
                if bad:
                    msg += (f", and their attention stages' head dims ({', '.join(bad)}) are not multiples "
                            "of 6, which PointROPE needs")
            raise TypeError(msg)
        if attn_drop or proj_drop:
            raise NotImplementedError("LitePT-v1: attention and projection dropout are not ported")
        if bad:
            raise ValueError(f"LitePT-v1: PointROPE needs head dims that are multiples of 6 (three parts of "
                             f"rotation pairs); got {', '.join(bad)}")
        self.enc_mode = enc_mode
        self.order = (order,) if isinstance(order, str) else tuple(order)
        self.stride = tuple(stride)
        self.enc_depths = tuple(enc_depths)
        self.dec_depths = tuple(dec_depths)
        self.enc_channels = tuple(enc_channels)
        self.enc_patch_size = tuple(enc_patch_size)
        self.dec_patch_size = tuple(dec_patch_size)
        self.drop_path = drop_path
        self.shuffle_orders = shuffle_orders
        self.serialize_depth = serialize_depth
        self.pool_capacity_factors = tuple(pool_capacity_factors)
        self.grid_size = grid_size
        dec_depths_all = tuple(dec_depths) + (0,) * (n - len(dec_depths))
        # what each stage's context holds: a neighbour map where a conv of
        # its encoder or decoder blocks reads one, partitions where an
        # attention does
        self.needs = [(bool(enc_conv[s] and enc_depths[s]) or bool(s < n - 1 and dec_conv[s] and dec_depths_all[s]),
                       bool(enc_attn[s] and enc_depths[s]) or bool(s < n - 1 and dec_attn[s] and dec_depths_all[s]))
                      for s in range(n)]
        enc_dp = np.linspace(0, drop_path, max(sum(enc_depths), 1)).tolist()

        self.embedding = Embedding(in_channels, enc_channels[0])
        self.enc = nn.Module()
        for s in range(n):
            stage = nn.Module()
            if s > 0:
                stage.down = SerializedPooling(enc_channels[s - 1], enc_channels[s], stride=stride[s - 1])
            for i in range(enc_depths[s]):
                stage.add_module(f"block{i}", LitePTBlock(
                    enc_channels[s], enc_num_head[s], enc_patch_size[s], enc_rope_freq[s], mlp_ratio, qkv_bias,
                    qk_scale, enc_dp[sum(enc_depths[:s]) + i], pre_norm, enc_conv[s], enc_attn[s]))
            self.enc.add_module(f"enc{s}", stage)
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        self.dec = nn.Module()
        for s in reversed(range(0 if enc_mode else n - 1)):
            stage = nn.Module()
            stage.up = SerializedUnpooling(dec_ch[s + 1], enc_channels[s], dec_ch[s])
            for i in range(dec_depths[s]):
                stage.add_module(f"block{i}", LitePTBlock(
                    dec_ch[s], dec_num_head[s], dec_patch_size[s], dec_rope_freq[s], mlp_ratio, qkv_bias,
                    qk_scale, 0.0, pre_norm, dec_conv[s], dec_attn[s]))
            self.dec.add_module(f"dec{s}", stage)
        self.out_channels = enc_channels[-1] if enc_mode else dec_ch[0]

    def _stage_ctx(self, pb: PointBatch, s: int, depth: int, nbr5) -> dict:
        need_conv, need_attn = self.needs[s]
        nbr3 = parts = None
        if need_conv:
            if s == 0:
                # the stage-0 k3 map is a column subset of the stem's k5 map
                nbr3 = nbr5[:, torch.as_tensor(k3_columns_of_k5(), device=pb.device).long()]
            else:
                nbr3 = build_subm_neighbor_map(pb.grid_coord, pb.key_batch(), pb.mask, depth - s, 3)
        if need_attn:
            s_orders = len(self.order)
            used = {i % s_orders for i in range(self.enc_depths[s])}
            if s < len(self.dec_depths):
                used |= {i % s_orders for i in range(self.dec_depths[s])}
            patch = self.enc_patch_size[s]
            if s < len(self.dec_depths) and self.dec_depths[s] and self.dec_patch_size[s] != patch:
                raise ValueError(f"LitePT-v1: decoder stage {s} reuses its encoder stage's partitions, "
                                 f"whose patch size {patch} differs from its {self.dec_patch_size[s]}")
            parts = patch_runs({oi: pb.patch_partition(oi, patch) for oi in sorted(used)})
        return dict(nbr3=nbr3, parts=parts)

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None):
        s_orders = len(self.order)
        num_stages = len(self.enc_depths)
        shuffled = self.training and self.shuffle_orders
        if generator is None and self.training and (shuffled or self.drop_path > 0):
            raise ValueError("LitePT-v1: train mode draws its order shuffles and drop-path masks "
                             "from an explicit generator")
        diag = {"pool_overflow": [], "block_overflow": []}
        pb = pb.with_grid_coord(self.grid_size)
        depth = serialization_depth(self.serialize_depth, pb)
        pb = pb.serialize(orders=self.order, depth=depth, generator=generator if shuffled else None)
        nbr5 = build_subm_neighbor_map(pb.grid_coord, pb.key_batch(), pb.mask, depth, 5)
        pb = self.embedding(pb, nbr5)

        skips = []
        ctx = None
        cap = pb.capacity
        for s in range(num_stages):
            stage = getattr(self.enc, f"enc{s}")
            if s > 0:
                cap = _round_up(max(int(math.ceil(cap * self.pool_capacity_factors[s - 1])), 128), 128)
                skip_pb = pb
                pb, cluster, overflow = stage.down(pb, cap, self.order, None, False,
                                                   generator if shuffled else None)
                diag["pool_overflow"].append(overflow)
                skips.append((skip_pb, cluster, ctx))
            ctx = self._stage_ctx(pb, s, depth, nbr5)
            for i in range(self.enc_depths[s]):
                part = None if ctx["parts"] is None else ctx["parts"][i % s_orders]
                pb = getattr(stage, f"block{i}")(pb, ctx["nbr3"], part, generator)
        if self.enc_mode:
            return pb, diag, skips

        for s in reversed(range(num_stages - 1)):
            stage = getattr(self.dec, f"dec{s}")
            skip_pb, cluster, skip_ctx = skips[s]
            pb, _ = stage.up(pb, skip_pb, cluster)
            for i in range(self.dec_depths[s]):
                part = None if skip_ctx["parts"] is None else skip_ctx["parts"][i % s_orders]
                pb = getattr(stage, f"block{i}")(pb, skip_ctx["nbr3"], part, generator)
        pb = pb.replace(serialized_keys=None, serialized_order=None, serialized_inverse=None)
        return pb, diag
