"""Cross-entropy (counterpart of `CrossEntropyLoss` in
`pointcept_tpu/models/losses/misc.py`). Takes logits [N, C] and labels [N];
labels equal to ``ignore_index`` (padding points carry -1) are masked out."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .builder import LOSSES


@LOSSES.register_module()
class CrossEntropyLoss:
    def __init__(
        self,
        weight: Optional[Sequence[float]] = None,
        size_average=None,
        reduce=None,
        reduction: str = "mean",
        label_smoothing: float = 0.0,
        loss_weight: float = 1.0,
        ignore_index: int = -1,
    ):
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)
        self.reduction = reduction
        self.label_smoothing = label_smoothing
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        c = pred.shape[1]
        valid = target != self.ignore_index
        t = torch.where(valid, target, 0).long()
        onehot = F.one_hot(t, c).float()
        if self.label_smoothing > 0:
            onehot = onehot * (1 - self.label_smoothing) + self.label_smoothing / c
        ce = -(onehot * F.log_softmax(pred.float(), dim=-1)).sum(dim=-1)
        w = valid.float()
        if self.weight is not None:
            w = w * self.weight.to(pred.device)[t]
        if self.reduction == "mean":
            loss = (ce * w).sum() / torch.clamp(w.sum(), min=1e-12)
        elif self.reduction == "sum":
            loss = (ce * w).sum()
        else:
            loss = ce * w
        return loss * self.loss_weight
