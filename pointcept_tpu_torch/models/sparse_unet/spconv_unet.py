"""SpUNet (MinkUNet-style sparse-conv U-Net), eval and train forward
(counterpart of `pointcept_tpu/models/sparse_unet/spconv_unet.py`).

SubM k5 stem -> 4x [SparseConv k2 s2 + BasicBlock x L] -> 4x
[SparseInverseConv k2 + skip concat + BasicBlock x L] -> SubM k1 head. Each
resolution level builds one neighbour structure, shared by all its convs:
block-dense tables (8^3 blocks) where the level holds at least
`block_engine_min_points` rows and ``conv_engine="block"``, a gather rule
map otherwise; each striding builds one parent/child table. The feature
stream is f32; submanifold convs round their operands to bf16 and
accumulate in f32, as the JAX package does. ``block_conv_fused=True`` runs
the block convs as the fused implicit GEMM (`FusedBlockConv`, the JAX
package's ``BLOCK_CONV_FUSED=1``).

Parameter names follow the reference Pointcept state dict (`conv_input.0`,
`down.{s}.0`, `enc.{s}.block{i}.conv1`, `up.{s}.0`, `dec.{s}.block{i}`,
`final`), so the JAX package's `convert_spunet` reads them directly. Conv
weights are ``[k^3, Cin, Cout]`` in `kernel_offsets` order.

SpUNet-v1m3 (Point Prompt Training: ``conditions``, ``norm_decouple``,
``norm_adaptive``; or ``pdnorm_bn`` and the ``pdnorm_*`` names on any
variant) puts a `PDBatchNorm` at every norm: the stem's, each striding's
and inverse striding's, and each block's bn1, bn2 and projection norm. Each
reads the batch's ``condition`` and ``context``. As in the JAX package,
those norms keep PDNorm's own eps 1e-3 and momentum 0.01 whatever
``bn_eps`` / ``bn_momentum`` say.

Not ported: ``enc_mode``; it raises when asked for.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ...ops import serialization as ser
from ...ops.block_conv import block_subm_conv, build_block_tables, default_block_capacity
from ...ops.sparse_conv import (
    build_strided_maps, build_subm_neighbor_map, gather_conv, inverse_conv, k3_columns_of_k5,
    strided_conv,
)
from ..builder import MODELS
from ..modules import MaskedBatchNorm, PDBatchNorm, apply_norm
from ..utils.structure import PointBatch, serialization_depth


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _self_map(mask: torch.Tensor) -> torch.Tensor:
    """[N, 1] rule map of a k1 conv: each valid row reads itself."""
    return torch.where(mask, torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device),
                       -1)[:, None]


class SpSubMConv(nn.Module):
    """Submanifold conv, weight [k^3, Cin, Cout]: the block-dense engine when
    given block tables (fused with `fused`), bf16 gather-GEMM otherwise."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, bias: bool = False,
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


class _Weight(nn.Module):
    """A bare conv weight [k^3, Cin, Cout] (the reference's strided and
    inverse spconv layers, named `.0` of their Sequential)."""

    def __init__(self, k3: int, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(k3, in_channels, out_channels))


def _bn(channels: int, eps: float, momentum: float, pd: Optional[dict]) -> nn.Module:
    """A `MaskedBatchNorm`, or with `pd` (conditions, decouple, adaptive,
    context_channels) a `PDBatchNorm` at PDNorm's own eps and momentum."""
    if pd is not None:
        return PDBatchNorm(channels, pd["conditions"], pd["decouple"], pd["adaptive"], pd["context_channels"])
    return MaskedBatchNorm(channels, eps=eps, momentum=momentum)


class BasicBlock(nn.Module):
    """Residual SubM k3 block (reference `spconv_unet_v1m1_base.py:23-85`):
    conv1, bn1, conv2, bn2 and, where the width changes, proj.{0,1}. bn1/bn2
    take `bn_momentum`, the projection norm `proj_bn_momentum`; with `pd`,
    each is a `PDBatchNorm`."""

    def __init__(self, in_channels: int, embed_channels: int, bn_momentum: float = 0.01,
                 proj_bn_momentum: float = 0.01, bn_eps: float = 1e-3, fused: bool = False,
                 pd: Optional[dict] = None):
        super().__init__()
        self.conv1 = SpSubMConv(in_channels, embed_channels, 3, fused=fused)
        self.bn1 = _bn(embed_channels, bn_eps, bn_momentum, pd)
        self.conv2 = SpSubMConv(embed_channels, embed_channels, 3, fused=fused)
        self.bn2 = _bn(embed_channels, bn_eps, bn_momentum, pd)
        self.proj = None
        if in_channels != embed_channels:
            self.proj = nn.ModuleList([
                SpSubMConv(in_channels, embed_channels, 1),
                _bn(embed_channels, bn_eps, proj_bn_momentum, pd),
            ])

    def forward(self, feat: torch.Tensor, nbr3, mask: torch.Tensor, pb: PointBatch) -> torch.Tensor:
        out = torch.relu(apply_norm(self.bn1, self.conv1(feat, nbr3), pb, mask))
        out = apply_norm(self.bn2, self.conv2(out, nbr3), pb, mask)
        residual = feat
        if self.proj is not None:
            residual = apply_norm(self.proj[1], self.proj[0](feat, _self_map(mask)), pb, mask)
        return torch.relu(out + residual)


def _conv_bn(k3: int, cin: int, cout: int, eps: float, momentum: float, pd: Optional[dict]) -> nn.ModuleList:
    return nn.ModuleList([_Weight(k3, cin, cout), _bn(cout, eps, momentum, pd)])


@MODELS.register_module("SpUNet-v1m1")
class SpUNetBase(nn.Module):
    """SpUNet-v1m1 backbone; `forward(pb, generator)` returns (PointBatch
    whose feat is the per-point logits, or the last decoder features when
    ``num_classes`` is 0; diagnostics). The diagnostics count the points
    dropped by static capacities: ``block_overflow`` (one per block-table
    build) and ``pool_overflow`` (one per striding). `generator` is unused:
    nothing in SpUNet is random. A batch whose features are not
    ``in_channels`` wide raises."""

    bn_momentum_default = 0.01
    bn_eps_default = 1e-3
    transition_bn_momentum_default: Optional[float] = None
    pdnorm_default = False

    def __init__(
        self,
        in_channels: int = 6,
        num_classes: int = 0,
        base_channels: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
        serialize_depth: int = 12,
        pool_capacity_factor: float = 0.5,
        conv_engine: str = "gather",
        block_capacity_factor: float = 1.0 / 16.0,
        block_engine_min_points: int = 8192,
        block_conv_fused: bool = False,
        grid_size: float = 0.02,
        bn_momentum: Optional[float] = None,
        bn_eps: Optional[float] = None,
        transition_bn_momentum: Optional[float] = None,
        enc_mode: bool = False,
        pdnorm_bn: bool = False,
        conditions: Optional[Sequence[str]] = None,
        pdnorm_decouple: bool = True,
        pdnorm_adaptive: bool = False,
        pdnorm_conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D"),
        norm_decouple: Optional[bool] = None,
        norm_adaptive: Optional[bool] = None,
        context_channels: int = 256,
        # config-parity options without effect (the norms are always affine;
        # the reference SpUNet-v1m3's zero_init), as in the JAX package
        pdnorm_affine: bool = True,
        norm_affine: Optional[bool] = None,
        zero_init: bool = False,
    ):
        super().__init__()
        if enc_mode:
            raise NotImplementedError("SpUNet: enc_mode is not ported yet")
        pd = None
        if pdnorm_bn or self.pdnorm_default or conditions is not None:
            # the reference SpUNet-v1m3's names (conditions, norm_*) over the pdnorm_* ones
            pd = dict(conditions=tuple(conditions if conditions is not None else pdnorm_conditions),
                      decouple=pdnorm_decouple if norm_decouple is None else norm_decouple,
                      adaptive=pdnorm_adaptive if norm_adaptive is None else norm_adaptive,
                      context_channels=context_channels)
        self.in_channels = in_channels
        if conv_engine not in ("gather", "block"):
            raise ValueError(f"SpUNet: unknown conv_engine {conv_engine!r}")
        channels, layers = tuple(channels), tuple(layers)
        assert len(layers) % 2 == 0 and len(layers) == len(channels)
        self.num_stages = n = len(layers) // 2
        self.layers = layers
        self.serialize_depth = serialize_depth
        self.pool_capacity_factor = pool_capacity_factor
        self.conv_engine = conv_engine
        self.block_capacity_factor = block_capacity_factor
        self.block_engine_min_points = block_engine_min_points
        self.grid_size = grid_size
        mom = self.bn_momentum_default if bn_momentum is None else bn_momentum
        eps = self.bn_eps_default if bn_eps is None else bn_eps
        tmom = transition_bn_momentum if transition_bn_momentum is not None else (
            self.transition_bn_momentum_default if self.transition_bn_momentum_default is not None
            else mom)
        fused = block_conv_fused

        self.conv_input = nn.ModuleList([
            SpSubMConv(in_channels, base_channels, 5, fused=fused), _bn(base_channels, eps, tmom, pd),
        ])
        self.down, self.enc = nn.ModuleList(), nn.ModuleList()
        self.up, self.dec = nn.ModuleList(), nn.ModuleList()
        enc_ch = [base_channels] + list(channels[:n])
        for s in range(n):
            self.down.append(_conv_bn(8, enc_ch[s], channels[s], eps, tmom, pd))
            stage = nn.Module()
            for i in range(layers[s]):
                cin = channels[s]
                stage.add_module(f"block{i}", BasicBlock(cin, channels[s], mom, tmom, eps, fused, pd))
            self.enc.append(stage)
        # decoder of level s: from level s+1's width (the last encoder's, or
        # the decoder below's) to channels[2n - 1 - s], concatenated with
        # level s's skip (the reference's dec_channels)
        for s in range(n):
            dec_out = channels[2 * n - 1 - s]
            dec_in = channels[n - 1] if s == n - 1 else channels[2 * n - 2 - s]
            self.up.append(_conv_bn(8, dec_in, dec_out, eps, tmom, pd))
            stage = nn.Module()
            for i in range(layers[2 * n - 1 - s]):
                cin = dec_out + enc_ch[s] if i == 0 else dec_out
                stage.add_module(f"block{i}", BasicBlock(cin, dec_out, mom, tmom, eps, fused, pd))
            self.dec.append(stage)
        self.out_channels = num_classes if num_classes > 0 else channels[-1]
        self.final = SpSubMConv(channels[-1], num_classes, 1, bias=True) if num_classes > 0 else None

    def _use_block(self, capacity: int) -> bool:
        return self.conv_engine == "block" and capacity >= self.block_engine_min_points

    def _geometry(self, grid, kb, mask, depth: int, capacity: int, kernel_size: int, diag: dict):
        if self._use_block(capacity):
            keys0 = ser.encode(grid, kb, depth, "z")
            t = build_block_tables(keys0, ser.argsort_keys(keys0, depth), grid, mask, depth,
                                   default_block_capacity(capacity, self.block_capacity_factor))
            diag["block_overflow"].append(t["overflow"])
            return t
        return build_subm_neighbor_map(grid, kb, mask, depth, kernel_size)

    def geometry(self, pb: PointBatch):
        """The structures of every resolution level, built once per forward
        from a batch with grid coordinates: ``levels[s] = dict(mask, nbr)``
        (level 0's `nbr` serves the k5 stem, every other level's its k3
        convs: block tables or a gather rule map), ``strided[s]`` the maps
        from level s to s+1 (`build_strided_maps`), and the diagnostics."""
        diag = {"block_overflow": [], "pool_overflow": []}
        depth = serialization_depth(self.serialize_depth, pb)
        grid = torch.clamp(pb.grid_coord, 0, (1 << depth) - 1)
        kb, mask = pb.key_batch(), pb.mask
        cap = pb.capacity
        levels = [dict(mask=mask, nbr=self._geometry(grid, kb, mask, depth, cap, 5, diag))]
        strided = []
        for _ in range(self.num_stages):
            cap = _round_up(max(int(math.ceil(cap * self.pool_capacity_factor)), 128), 128)
            st = build_strided_maps(grid, kb, mask, depth, cap)
            diag["pool_overflow"].append(st["overflow"])
            mask = st["out_batch"] >= 0
            kb = torch.where(mask, st["out_batch"], ser.BATCH_SENTINEL).to(torch.int32)
            grid, depth = st["out_grid"], depth - 1
            levels.append(dict(mask=mask, nbr=self._geometry(grid, kb, mask, depth, cap, 3, diag)))
            strided.append(st)
        return levels, strided, diag

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None):
        n = self.num_stages
        if pb.feat.shape[1] != self.in_channels:
            raise ValueError(f"SpUNet stem: in_channels={self.in_channels} but the batch's features have "
                             f"{pb.feat.shape[1]} channels")
        pb = pb.with_grid_coord(self.grid_size)
        levels, strided, diag = self.geometry(pb)
        mask, nbr5 = levels[0]["mask"], levels[0]["nbr"]
        feat = torch.relu(apply_norm(self.conv_input[1], self.conv_input[0](pb.feat, nbr5), pb, mask))

        skips = [feat]
        for s in range(n):
            lv, down = levels[s + 1], self.down[s]
            feat = torch.relu(apply_norm(down[1], strided_conv(feat, strided[s]["child"], down[0].weight), pb,
                                         lv["mask"]))
            for i in range(self.layers[s]):
                feat = getattr(self.enc[s], f"block{i}")(feat, lv["nbr"], lv["mask"], pb)
            skips.append(feat)

        feat = skips.pop()
        for s in reversed(range(n)):
            st, up = strided[s], self.up[s]
            lv_mask = levels[s]["mask"]
            feat = inverse_conv(feat, st["parent_of"], st["child_slot"], up[0].weight)
            feat = torch.relu(apply_norm(up[1], feat, pb, lv_mask))
            feat = torch.cat([feat, skips.pop()], dim=-1)
            if s > 0 or isinstance(nbr5, dict):
                nbr3 = levels[s]["nbr"]  # block tables serve every kernel size
            else:
                # the level-0 k3 map is a column subset of the stem's k5 map
                nbr3 = nbr5[:, torch.as_tensor(k3_columns_of_k5(), device=nbr5.device).long()]
            for i in range(self.layers[2 * n - 1 - s]):
                feat = getattr(self.dec[s], f"block{i}")(feat, nbr3, lv_mask, pb)

        if self.final is not None:
            feat = gather_conv(feat, _self_map(mask), self.final.weight, self.final.bias)
        return pb.replace(feat=feat), diag


@MODELS.register_module("SpUNet-v1m2")
class SpUNetBNMomentum(SpUNetBase):
    """bn-momentum variant (reference `spconv_unet_v1m2_bn_momentum.py`):
    block norms momentum 0.1 (configurable), stem/transition/projection
    norms momentum 0.02, eps 1e-5."""

    bn_momentum_default = 0.1
    bn_eps_default = 1e-5
    transition_bn_momentum_default = 0.02


@MODELS.register_module("SpUNet-v1m3")
class SpUNetPDNorm(SpUNetBase):
    """SpUNet with Prompt-Driven Normalization for Point Prompt Training
    (reference `spconv_unet_v1m3_pdnorm.py`): `PDBatchNorm` at every norm,
    of ``conditions`` (the JAX package's default three without it)."""

    pdnorm_default = True


# MinkUNet family (reference `sparse_unet/mink_unet.py:365-405`): layer and
# channel presets of the same sparse residual U-Net, as the JAX package maps them
_MINK_PRESETS = {
    "MinkUNet14": (1, 1, 1, 1, 1, 1, 1, 1),
    "MinkUNet18": (2, 2, 2, 2, 2, 2, 2, 2),
    "MinkUNet34": (2, 3, 4, 6, 2, 2, 2, 2),
    "MinkUNet50": (2, 3, 4, 6, 2, 2, 2, 2),
    "MinkUNet101": (2, 3, 4, 23, 2, 2, 2, 2),
}
_MINK_CHANNELS = {
    "A": (32, 64, 128, 256, 128, 128, 96, 96),
    "B": (32, 64, 128, 256, 128, 128, 128, 128),
    "C": (32, 64, 128, 256, 256, 128, 96, 96),
    "D": (32, 64, 128, 256, 384, 384, 384, 384),
}


def _mink_preset(name: str, layers, channels):
    def __init__(self, *args, layers=layers, channels=channels, **kwargs):
        SpUNetBase.__init__(self, *args, layers=layers, channels=channels, **kwargs)

    return type(name, (SpUNetBase,), {"__init__": __init__})


for _name, _layers in _MINK_PRESETS.items():
    for _var, _ch in _MINK_CHANNELS.items():
        MODELS.register_module(name=f"{_name}{_var}", module=_mink_preset(f"{_name}{_var}", _layers, _ch))
