"""Context-Aware Classifier (CAC-v1m1; counterpart of
`pointcept_tpu/models/context_aware_classifier/context_aware_classifier.py`,
reference `context_aware_classifier_v1m1_base.py`).

A backbone that emits features (SpUNet with ``num_classes=0``, PT-v2 without
a seg head), a linear classifier whose weight rows are the class
prototypes, and two refinements of them: each scene's prototypes from its
points' softmax-weighted features (`post_refine_proto_batch`, the output
logits) and, in train mode, the labels' class means (`get_adaptive_perspective`),
each projected with the classifier's prototypes and compared by cosine
with the projected features. Train mode sums four criteria (the refined
logits, the adaptive ones, the plain classifier's) and an entropy-weighted
distillation of the adaptive logits into the refined ones; eval returns
the refined logits and the plain classifier's loss, as the JAX package.

The per-scene sums run as dense contractions over a scene one-hot, the
distillation's class sums as one-hot contractions, so the card sums them in
a fixed order. Names are the reference's: ``seg_head``, ``proj.{0,2}``,
``apd_proj.{0,2}``, ``feat_proj_layer.{0,1,3}`` (its BatchNorm the JAX
package's `MaskedBatchNorm`, momentum 0.01 and eps 1e-3).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import MODELS
from ..losses import build_criteria
from ..modules import Linear, MaskedBatchNorm
from ..utils.structure import PointBatch


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


@MODELS.register_module("CAC-v1m1")
class CACSegmentor(nn.Module):
    """`forward(pb, generator)` returns ``{"seg_logits", "diagnostics"}``
    and, with labels, ``"loss"`` (train mode also ``seg_loss``,
    ``pre_loss``, ``pre_self_loss``, ``kl_loss``). The backbone's features
    must be `backbone_out_channels` wide."""

    def __init__(self, num_classes: int = 20, backbone_out_channels: int = 64, backbone=None, criteria=None,
                 cos_temp: float = 15.0, main_weight: float = 1.0, pre_weight: float = 1.0,
                 pre_self_weight: float = 1.0, kl_weight: float = 1.0, conf_thresh: float = 0.0,
                 detach_pre_logits: bool = False):
        super().__init__()
        self.backbone = MODELS.build(dict(backbone))
        c = backbone_out_channels
        if self.backbone.out_channels != c:
            raise ValueError(f"CAC-v1m1: backbone_out_channels={c} but the backbone emits "
                             f"{self.backbone.out_channels} channels (num_classes=0 gives its features)")
        self.num_classes = num_classes
        self.cos_temp = cos_temp
        self.weights = dict(main=main_weight, pre=pre_weight, pre_self=pre_self_weight, kl=kl_weight)
        self.conf_thresh = conf_thresh
        self.detach_pre_logits = detach_pre_logits
        self.criteria = build_criteria(criteria)
        self.seg_head = Linear(c, num_classes)
        self.proj = nn.Sequential(Linear(2 * c, 2 * c, bias=False), nn.ReLU(), Linear(2 * c, c))
        self.apd_proj = nn.Sequential(Linear(2 * c, 2 * c, bias=False), nn.ReLU(), Linear(2 * c, c))
        self.feat_proj_layer = nn.Sequential(Linear(c, c, bias=False), MaskedBatchNorm(c), nn.ReLU(), Linear(c, c))

    def _feat_proj(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        f = self.feat_proj_layer
        return f[3](F.relu(f[1](f[0](x), mask)))

    def post_refine_proto_batch(self, feat: torch.Tensor, pred: torch.Tensor, proto: torch.Tensor,
                                pb: PointBatch) -> torch.Tensor:
        """Each point's cosine logits against its scene's refined prototypes:
        the scene's softmax-weighted feature mean a class (beside the
        classifier's prototype, through ``proj``)."""
        if self.detach_pre_logits:
            pred = pred.detach()
        b = pb.num_scenes
        p = torch.softmax(pred.float(), dim=1)
        if self.conf_thresh > 0:
            p = p * (p.max(dim=1, keepdim=True).values >= self.conf_thresh)
        p = p * pb.mask[:, None]
        onehot = F.one_hot(torch.clamp(pb.batch, 0, b - 1).long(), b).to(p.dtype) * pb.mask[:, None]
        denom = onehot.T @ p + 1e-7  # [B, cls]
        proto_b = torch.einsum("nb,nc,nd->bcd", onehot, p, feat.to(p.dtype)) / denom[..., None]
        proto_b = torch.cat([proto_b, proto[None].expand(b, -1, -1).to(p.dtype)], dim=-1)
        proto_b = self.proj(proto_b)
        x = _unit(self._feat_proj(feat, pb.mask))
        per_scene = torch.einsum("nd,bcd->nbc", x, _unit(proto_b))
        return per_scene[torch.arange(x.shape[0], device=x.device), torch.clamp(pb.batch, 0, b - 1).long()]

    def get_adaptive_perspective(self, feat: torch.Tensor, target: torch.Tensor, new_proto: torch.Tensor,
                                 proto: torch.Tensor, pb: PointBatch) -> torch.Tensor:
        """Cosine logits against the prototypes where each class the labels
        hold takes its points' mean feature (beside the classifier's
        prototype, through ``apd_proj``)."""
        valid = (target >= 0) & pb.mask
        onehot = F.one_hot(torch.clamp(target, 0, self.num_classes - 1).long(), self.num_classes).to(feat.dtype)
        onehot = onehot * valid[:, None].to(feat.dtype)
        counts = onehot.sum(dim=0)[:, None]
        class_mean = (onehot.T @ feat) / (counts + 1e-4)
        present = (counts > 0).to(feat.dtype)
        new_proto = new_proto * (1 - present) + class_mean * present
        new_proto = self.apd_proj(torch.cat([new_proto, proto], dim=-1))
        x = self._feat_proj(feat, pb.mask)
        return _unit(x) @ _unit(new_proto).T

    def get_distill_loss(self, pred: torch.Tensor, soft: torch.Tensor, target: torch.Tensor,
                         pb: PointBatch, smoothness: float = 0.5) -> torch.Tensor:
        """The refined logits' cross-entropy against the adaptive ones'
        softmax smoothed with the labels, a class's points weighted by that
        softmax's entropy, averaged over the classes the batch holds."""
        c = soft.shape[1]
        soft = soft.detach()
        valid = (target >= 0) & pb.mask
        sm = torch.softmax(soft.float(), dim=1)
        onehot = F.one_hot(torch.clamp(target, 0, c - 1).long(), c).float() * valid[:, None]
        smoothed = smoothness * sm + (1 - smoothness) * onehot
        loss = -(F.log_softmax(pred.float(), dim=1) * smoothed).sum(dim=1)
        entropy = -(sm * torch.log(sm + 1e-4)).sum(dim=1) * valid
        w_sum = onehot.T @ entropy
        l_sum = onehot.T @ (loss * entropy)
        present = (onehot.sum(dim=0) > 0).float()
        per_class = l_sum / (w_sum + 1e-4)
        return (per_class * present).sum() / torch.clamp(present.sum(), min=1e-4)

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None) -> dict:
        with contextlib.nullcontext() if self.training else torch.no_grad():
            out, diag = self.backbone(pb, generator=generator)
            feat = out.feat
            seg_logits = self.seg_head(feat)
            proto = self.seg_head.weight  # [cls, C]
            refine = self.post_refine_proto_batch(feat, seg_logits, proto, pb) * self.cos_temp
            result = {"seg_logits": refine, "diagnostics": diag}
            if pb.segment is None:
                return result
            target = pb.segment
            if not self.training:
                result["loss"] = self.criteria(seg_logits, target)
                return result
            cac = self.get_adaptive_perspective(feat, target, proto.detach(), proto, pb) * self.cos_temp
            w = self.weights
            losses = dict(seg_loss=self.criteria(refine, target) * w["main"],
                          pre_loss=self.criteria(cac, target) * w["pre"],
                          pre_self_loss=self.criteria(seg_logits, target) * w["pre_self"],
                          kl_loss=self.get_distill_loss(refine, cac, target, pb) * w["kl"])
            result.update(loss=sum(losses.values()), **losses)
        return result
