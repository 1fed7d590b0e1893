"""Task wrappers (counterpart of `pointcept_tpu/models/default.py`)."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..utils.logger import get_root_logger
from ..utils.optimizer import freeze_except
from .builder import MODELS
from .losses import build_criteria
from .modules import Linear
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
