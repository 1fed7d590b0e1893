"""PointGroup instance segmentation (counterparts of `PG-v1m1` and `PG-v1m2` in
`pointcept_tpu/models/point_group/point_group.py`; reference
`point_group_v1m1_base.py:24`, `point_group_v1m2_custom_criteria.py:25`).

A semantic head and a centre-offset (bias) head over any backbone. The
losses: cross-entropy over the labelled points (`PG-v1m2`: the config's
criteria), plus the L1 distance and the negative cosine between the
predicted offset and the instance centroid's offset, over the points that
belong to an instance. Proposals (`propose_instances`) run on the host, as
in the JAX package and the reference: the points shifted by their offsets
are clustered by `ops.clustering.bfs_cluster` within each predicted class.

State-dict names are the reference's: ``bias_head.0`` (Linear),
``bias_head.1`` (BatchNorm), ``bias_head.3`` (Linear to 3), ``seg_head``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..builder import MODELS
from ..default import DefaultSegmentorV2
from ..losses import build_criteria
from ..modules import Linear, MaskedBatchNorm
from ..utils.structure import PointBatch


def offset_losses(bias_pred: torch.Tensor, pb: PointBatch, instance_ignore_index: int) -> dict:
    """The L1 distance and the negative cosine of the predicted offsets to
    ``instance_centroid - coord``, averaged over the valid points that
    belong to an instance."""
    inst_mask = ((pb.instance != instance_ignore_index) & pb.mask).float()
    bias_pred = bias_pred.float()
    bias_gt = pb.instance_centroid - pb.coord
    denom = inst_mask.sum() + 1e-8
    l1 = (torch.abs(bias_pred - bias_gt).sum(dim=-1) * inst_mask).sum() / denom
    pred_norm = bias_pred / (torch.linalg.vector_norm(bias_pred, dim=1, keepdim=True) + 1e-8)
    gt_norm = bias_gt / (torch.linalg.vector_norm(bias_gt, dim=1, keepdim=True) + 1e-8)
    cosine = -(pred_norm * gt_norm).sum(dim=-1)
    return dict(bias_l1_loss=l1, bias_cosine_loss=(cosine * inst_mask).sum() / denom)


@MODELS.register_module("PG-v1m1")
class PointGroup(DefaultSegmentorV2):
    """`forward(pb, generator)` returns ``{"seg_logits", "bias_pred",
    "diagnostics"}`` and, when the batch carries ``segment``, ``instance``
    and ``instance_centroid``, ``"loss"`` = ``seg_loss + bias_l1_loss +
    bias_cosine_loss`` with the three terms. The backbone is built as
    `DefaultSegmentorV2` builds it (an ``enc_mode`` backbone read through
    its up-cast); the heads compute in f32 over a bf16 stream."""

    def __init__(self, backbone=None, backbone_out_channels: int = 64, semantic_num_classes: int = 20,
                 semantic_ignore_index: int = -1, segment_ignore_index: Sequence[int] = (-1, 0, 1),
                 instance_ignore_index: int = -1, cluster_thresh: float = 1.5, cluster_closed_points: int = 300,
                 cluster_propose_points: int = 100, cluster_min_points: int = 50, voxel_size: float = 0.02,
                 freeze_backbone: bool = False, up_cast_level: int = 0):
        nn.Module.__init__(self)
        in_ch = self.build_backbone(backbone, backbone_out_channels, up_cast_level, freeze_backbone)
        self.semantic_num_classes = semantic_num_classes
        self.semantic_ignore_index = semantic_ignore_index
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.cluster_thresh = cluster_thresh
        self.cluster_closed_points = cluster_closed_points
        self.cluster_propose_points = cluster_propose_points
        self.cluster_min_points = cluster_min_points
        self.voxel_size = voxel_size
        self.bias_head = nn.Sequential(Linear(in_ch, backbone_out_channels), MaskedBatchNorm(backbone_out_channels),
                                       nn.ReLU(), Linear(backbone_out_channels, 3))
        self.seg_head = Linear(in_ch, semantic_num_classes)

    def seg_loss(self, logits: torch.Tensor, pb: PointBatch) -> torch.Tensor:
        """Cross-entropy over the valid points whose label is not ignored."""
        seg = pb.segment.long()
        valid = (seg != self.semantic_ignore_index) & pb.mask
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -torch.gather(logp, 1, torch.clamp(seg, min=0)[:, None])[:, 0]
        return torch.where(valid, ce, 0.0).sum() / torch.clamp(valid.sum(), min=1)

    def forward(self, pb: PointBatch, generator: Optional[torch.Generator] = None) -> dict:
        with contextlib.nullcontext() if self.training else torch.no_grad():
            out, diag = self.backbone_forward(pb, generator)
            feat = out.feat
            fc1, norm, _, fc2 = self.bias_head
            bias_pred = fc2(torch.relu(norm(fc1(feat), pb.mask)))
            logits = self.seg_head(feat)
            result = {"seg_logits": logits, "bias_pred": bias_pred, "diagnostics": diag}
            if pb.segment is not None and pb.instance is not None and pb.instance_centroid is not None:
                result["seg_loss"] = self.seg_loss(logits, pb)
                result.update(offset_losses(bias_pred, pb, self.instance_ignore_index))
                result["loss"] = result["seg_loss"] + result["bias_l1_loss"] + result["bias_cosine_loss"]
        return result

    # ------------------------------------------------------- host-side proposals
    def propose_instances(self, coord, bias_pred, seg_prob, batch, mask):
        """Host-side clustering (numpy), the JAX package's: the argmax class
        of each valid point outside `segment_ignore_index`, its coordinate
        shifted by its offset in voxels, `bfs_cluster` within each class
        (radius `cluster_thresh`, at most `cluster_closed_points` new
        neighbours a point, clusters of `cluster_min_points` or more); a
        cluster of more than `cluster_propose_points` points is a proposal
        of its first point's class, scored by the mean probability of that
        class over its points.

        Returns (masks [P, N] bool, classes [P] int32, scores [P] float32)."""
        from ...ops.clustering import bfs_cluster

        coord, bias_pred, seg_prob = np.asarray(coord), np.asarray(bias_pred), np.asarray(seg_prob)
        batch, mask = np.asarray(batch), np.asarray(mask)
        n = coord.shape[0]
        none = np.zeros((0, n), bool), np.zeros(0, np.int32), np.zeros(0, np.float32)
        segment_pred = seg_prob.argmax(-1)
        center_pred = (coord + bias_pred) / self.voxel_size
        keep = mask & ~np.isin(segment_pred, np.asarray(self.segment_ignore_index))
        if keep.sum() == 0:
            return none
        idx = np.where(keep)[0]
        cluster, num = bfs_cluster(center_pred[idx], batch[idx], segment_pred[idx].astype(np.int32),
                                   radius=self.cluster_thresh, min_points=self.cluster_min_points,
                                   max_neighbors=self.cluster_closed_points)
        masks, classes, scores = [], [], []
        for c in range(num):
            members = idx[cluster == c]
            if len(members) <= self.cluster_propose_points:
                continue
            m = np.zeros(n, bool)
            m[members] = True
            cls = segment_pred[members[0]]
            masks.append(m)
            classes.append(cls)
            scores.append(float(seg_prob[members, cls].mean()))
        if not masks:
            return none
        return np.stack(masks), np.asarray(classes, np.int32), np.asarray(scores, np.float32)


@MODELS.register_module("PG-v1m2")
class PointGroupV1M2(PointGroup):
    """PG-v1m2 (reference `point_group_v1m2_custom_criteria.py:25`):
    PointGroup whose semantic loss is the config's `criteria` (cross-entropy
    by default), with `freeze_backbone` and an ``enc_mode`` backbone's
    up-cast (Sonata's and Concerto's PointGroup probes).

    `freeze_backbone` freezes in the model, as `DefaultSegmentorV2` does:
    the backbone's parameters do not require gradients, so no optimizer
    group holds them and no decay moves them (the JAX package stops the
    gradient at the features, and its AdamW's decay still shrinks every
    backbone tensor). Its BatchNorm statistics still move in train mode."""

    def __init__(self, criteria=None, **kwargs):
        super().__init__(**kwargs)
        self.criteria = build_criteria(criteria if criteria is not None else
                                       [dict(type="CrossEntropyLoss", ignore_index=self.semantic_ignore_index)])

    def seg_loss(self, logits: torch.Tensor, pb: PointBatch) -> torch.Tensor:
        return self.criteria(logits, pb.segment)
