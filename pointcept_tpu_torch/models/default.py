"""Task wrappers (counterpart of `pointcept_tpu/models/default.py`)."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..ops.segment_ops import fixed_segment_mean
from ..utils.logger import get_root_logger
from ..utils.optimizer import freeze_except
from .builder import MODELS
from .losses import build_criteria
from .modules import Linear, MaskedBatchNorm
from .point_transformer_v3.point_transformer_v3 import up_cast
from .utils.structure import PointBatch


@MODELS.register_module("DefaultSegmentor")
class DefaultSegmentor(nn.Module):
    """Backbone that emits the per-point logits itself (SpUNet-style).

    `forward(pb, generator)` returns ``{"seg_logits", "diagnostics"}`` and,
    when the batch carries labels, the summed criteria as ``"loss"``;
    gradients are recorded in train mode only, as `DefaultSegmentorV2`."""

    def __init__(self, backbone=None, criteria=None, num_classes: int = 0):
        super().__init__()
        self.backbone = MODELS.build(dict(backbone))
        self.criteria = build_criteria(criteria)

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None) -> dict:
        with contextlib.nullcontext() if self.training else torch.no_grad():
            out, diag = self.backbone(pb, generator=generator)
            result = {"seg_logits": out.feat, "diagnostics": diag}
            if pb.segment is not None:
                result["loss"] = self.criteria(out.feat, pb.segment)
        return result


@MODELS.register_module("DefaultSegmentorV2")
class DefaultSegmentorV2(nn.Module):
    """Backbone returning a PointBatch, then a linear seg head (in f32).

    `forward(pb, generator, precomputed)` returns ``{"seg_logits", "feat",
    "diagnostics"}`` and, when the batch carries labels (``pb.segment``, -1 =
    ignore), the summed criteria as ``"loss"``. Gradients are recorded in
    train mode only; the eval forward runs under `torch.no_grad`. In train
    mode the backbone draws its order shuffles and drop-path masks from
    `generator`. `precomputed`: the backbone's `build_geometry` of the
    batch's points, shared by the batches of one voxel grid (PT-v3).

    An ``enc_mode`` backbone (Sonata's and Utonia's downstream configs)
    returns its skip chain too; the head reads the up-cast of
    `up_cast_level` levels of it (0: every level, as the JAX package), and
    its width is the up-cast's, as JAX's ``nn.Dense`` infers it (a config's
    differing `backbone_out_channels` is logged). `freeze_backbone` is the
    reference's: the backbone's parameters do not require gradients, so no
    optimizer group holds them, no graph is recorded through the backbone
    and its weights stay as loaded; its BatchNorm statistics still move in
    train mode."""

    def __init__(self, num_classes: int = 20, backbone_out_channels: int = 64, backbone=None,
                 criteria=None, freeze_backbone: bool = False, up_cast_level: int = 0):
        super().__init__()
        in_ch = self.build_backbone(backbone, backbone_out_channels, up_cast_level, freeze_backbone)
        self.criteria = build_criteria(criteria)
        self.seg_head = Linear(in_ch, num_classes) if num_classes > 0 else nn.Identity()

    def build_backbone(self, backbone: dict, backbone_out_channels: int, up_cast_level: int = 0,
                       freeze_backbone: bool = False) -> int:
        """Build ``self.backbone`` (frozen in the model with
        `freeze_backbone`) and return the width of the features a head
        reads: the decoder's, which must be `backbone_out_channels`, or an
        ``enc_mode`` backbone's up-cast of `up_cast_level` levels (0: every
        level), whose width wins over a differing `backbone_out_channels`
        (logged). PointGroup's models share it."""
        owner = type(self).__name__
        self.backbone = MODELS.build(dict(backbone))
        self.enc_mode = bool(getattr(self.backbone, "enc_mode", False))
        if self.enc_mode:
            enc = self.backbone.enc_channels
            self.up_cast_level = min(up_cast_level or len(enc) - 1, len(enc) - 1)
            in_ch = sum(enc[len(enc) - 1 - self.up_cast_level:])
            if backbone_out_channels != in_ch:
                get_root_logger().warning(
                    f"{owner}: backbone_out_channels={backbone_out_channels} but the up-cast of "
                    f"{self.up_cast_level} levels gives {in_ch} channels; the head takes {in_ch}")
        else:
            in_ch = self.backbone.out_channels
            if backbone_out_channels != in_ch:
                raise ValueError(f"backbone_out_channels={backbone_out_channels} but the backbone "
                                 f"emits {in_ch} channels")
        self.freeze_backbone = freeze_backbone
        if freeze_backbone:
            self.backbone.requires_grad_(False)
        return in_ch

    def backbone_forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None,
                         precomputed: Optional[dict] = None):
        """(the PointBatch a head reads, up-cast for an ``enc_mode``
        backbone; the backbone's diagnostics)."""
        kw = {} if precomputed is None else dict(precomputed=precomputed)
        if self.enc_mode:
            out, diag, skips = self.backbone(pb, generator=generator, **kw)
            return up_cast(out, skips, self.up_cast_level), diag
        return self.backbone(pb, generator=generator, **kw)

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None,
                precomputed: Optional[dict] = None) -> dict:
        with contextlib.nullcontext() if self.training else torch.no_grad():
            out, diag = self.backbone_forward(pb, generator, precomputed)
            logits = self.seg_head(out.feat)
            result = {"seg_logits": logits, "feat": out.feat, "diagnostics": diag}
            if pb.segment is not None:
                result["loss"] = self.criteria(logits, pb.segment)
        return result


@MODELS.register_module("DefaultLORASegmentorV2")
class DefaultLORASegmentorV2(DefaultSegmentorV2):
    """LoRA fine-tuning of a pretrained encoder (reference
    `models/default.py:99`, PEFT LoRA on the attention's qkv; counterpart
    of the JAX package's class of the same name): `DefaultSegmentorV2` with
    ``lora_rank`` put into the backbone's config, and every backbone tensor
    but the adapters' (``lora_a``, ``lora_b``) frozen in the model, as PEFT
    freezes it: ``requires_grad=False``, so no optimizer group holds them
    and their weights stay as loaded. The seg head stays trainable. The
    freezing holds whatever the config's optimizer block says: the LoRA
    configs' schedule block replaces ``optimizer`` with ``_delete_=True``
    and drops its ``trainable_keywords``, where the JAX package, which
    freezes through the optimizer, then trains every tensor. A
    `trainable_keywords` that is present narrows the trainable set further
    and never widens it. The frozen encoder's norms still update their
    running statistics in train mode, as the reference's do."""

    def __init__(self, backbone=None, lora_rank: int = 16, **kwargs):
        super().__init__(backbone=dict(backbone, lora_rank=lora_rank), **kwargs)
        freeze_except(self.backbone, ("lora",))


@MODELS.register_module("DefaultClassifier")
class DefaultClassifier(nn.Module):
    """Per-cloud classification (reference `models/default.py:290`;
    counterpart of the JAX package's class of the same name): the mean of
    each cloud's features over its valid points, then the head ``cls_head``:
    Linear -> BatchNorm -> ReLU -> Dropout(0.5), at 256 and at 128 channels,
    then Linear to `num_classes` (the reference's indices 0, 1, 4, 5, 8), in
    f32.

    `forward(pb, generator)` returns ``{"cls_logits" [num_scenes, classes],
    "diagnostics"}`` and, when the batch carries ``category`` (-1 for a
    scene the batch pads), the criteria of the logits against it as
    ``"loss"``. Gradients are recorded in train mode only.

    The pooled features are the last stage's (an ``enc_mode`` backbone) or
    the backbone's output (a decoder, SpUNet's features), as the JAX
    package pools: the head's width is theirs, and a differing
    `backbone_embed_dim` is logged, as the JAX head's inferred width ignores
    it (the Utonia configs say 1,386, the sum of the encoder's widths, over
    a last stage of 576). The mean runs in a fixed order
    (`fixed_segment_mean`). The head's BatchNorm takes the scenes that hold
    points: a padded scene (no points, ``category`` -1) adds nothing to its
    statistics (the JAX head's takes every scene). `freeze_backbone`
    freezes in the model, as `DefaultSegmentorV2`: the backbone's weights
    stay as loaded and no optimizer group holds them (the JAX package stops
    the gradient, and its weight decay still shrinks them). Dropout draws
    its masks from the step's `generator`."""

    def __init__(self, backbone=None, criteria=None, num_classes: int = 40, backbone_embed_dim: int = 256,
                 freeze_backbone: bool = False):
        super().__init__()
        self.backbone = MODELS.build(dict(backbone))
        self.enc_mode = bool(getattr(self.backbone, "enc_mode", False))
        width = self.backbone.out_channels
        if backbone_embed_dim != width:
            get_root_logger().warning(
                f"DefaultClassifier: backbone_embed_dim={backbone_embed_dim} but the backbone's pooled "
                f"features have {width} channels; the head takes {width}")
        self.freeze_backbone = freeze_backbone
        if freeze_backbone:
            self.backbone.requires_grad_(False)
        self.criteria = build_criteria(criteria)
        self.dropout = 0.5
        self.cls_head = nn.ModuleList([
            Linear(width, 256), MaskedBatchNorm(256), nn.ReLU(), nn.Identity(),
            Linear(256, 128), MaskedBatchNorm(128), nn.ReLU(), nn.Identity(),
            Linear(128, num_classes),
        ])

    def _drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.dropout == 0:
            return x
        if generator is None:
            raise ValueError("DefaultClassifier: train mode draws its dropout masks from an explicit generator")
        keep = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device) >= self.dropout
        return torch.where(keep, x / (1 - self.dropout), torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None) -> dict:
        with contextlib.nullcontext() if self.training else torch.no_grad():
            if self.enc_mode:
                out, diag, _ = self.backbone(pb, generator=generator)
            else:
                out, diag = self.backbone(pb, generator=generator)
            pooled = fixed_segment_mean(out.feat, out.batch, out.mask, pb.num_scenes)
            scenes = torch.arange(pb.num_scenes, device=out.batch.device)
            has_points = (out.batch[None, :] == scenes[:, None]).any(dim=1)
            x = pooled
            for i in (0, 4):
                x = self.cls_head[i + 1](self.cls_head[i](x), has_points)
                x = self._drop(torch.relu(x), generator)
            logits = self.cls_head[8](x)
            result = {"cls_logits": logits, "diagnostics": diag}
            if pb.category is not None:
                result["loss"] = self.criteria(logits, pb.category)
        return result
