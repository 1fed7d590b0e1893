"""Task wrappers (counterpart of `pointcept_tpu/models/default.py`)."""

from __future__ import annotations

import torch
from torch import nn

from .builder import MODELS
from .modules import Linear
from .utils.structure import PointBatch


@MODELS.register_module("DefaultSegmentorV2")
class DefaultSegmentorV2(nn.Module):
    """Backbone returning a PointBatch, then a linear seg head (in f32).

    Eval only: `forward` returns ``{"seg_logits", "feat", "diagnostics"}``.
    A batch with labels would need the loss, which is not ported yet."""

    def __init__(self, num_classes: int = 20, backbone_out_channels: int = 64, backbone=None,
                 criteria=None, freeze_backbone: bool = False, up_cast_level: int = 0):
        super().__init__()
        self.backbone = MODELS.build(dict(backbone))
        in_ch = self.backbone.out_channels
        if backbone_out_channels != in_ch:
            raise ValueError(f"backbone_out_channels={backbone_out_channels} but the backbone "
                             f"emits {in_ch} channels")
        self.seg_head = Linear(in_ch, num_classes) if num_classes > 0 else nn.Identity()

    def forward(self, pb: PointBatch) -> dict:
        if self.training:
            raise NotImplementedError("DefaultSegmentorV2: training is not ported yet; call .eval()")
        if pb.segment is not None:
            raise NotImplementedError("DefaultSegmentorV2: labels need the loss, not ported yet")
        with torch.no_grad():
            out, diag = self.backbone(pb)
            logits = self.seg_head(out.feat)
        return {"seg_logits": logits, "feat": out.feat, "diagnostics": diag}
