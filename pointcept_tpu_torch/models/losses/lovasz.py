"""Lovász-softmax loss, multiclass (counterpart of
`pointcept_tpu/models/losses/lovasz.py`), with the JAX package's static-shape
masking: ignored points get error -1, so they sort last under the
descending sort, and are masked out of the Jaccard cumsums. Classes absent
from the batch do not count ("present" classes). All classes are sorted at
once, one column each; the sort is stable, as `jnp.argsort` is."""

from __future__ import annotations

import torch

from .builder import LOSSES


def lovasz_softmax_flat(prob: torch.Tensor, target: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """prob [N, C] softmax probabilities; target [N] labels (any value where
    not `valid`)."""
    # one row per class, [C, N]: the sorts and scans run along the last dim
    c = prob.shape[1]
    fg = ((torch.arange(c, device=prob.device)[:, None] == target[None, :]) & valid[None, :]).float()
    errors = torch.where(valid[None, :], (fg - prob.T).abs(), -1.0)
    order = torch.argsort(-errors, dim=1, stable=True)
    errors_s = errors.gather(1, order)
    errors_s = torch.where(errors_s >= 0, errors_s, 0.0)
    fg_s = fg.gather(1, order)
    valid_s = valid.float()[order]
    gts = fg_s.sum(dim=1)
    intersection = gts[:, None] - torch.cumsum(fg_s, dim=1)
    union = gts[:, None] + torch.cumsum((1.0 - fg_s) * valid_s, dim=1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=1)
    losses = (errors_s * grad).sum(dim=1)
    present = (gts > 0).float()
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)


@LOSSES.register_module()
class LovaszLoss:
    def __init__(self, mode: str = "multiclass", class_seen=None, per_image: bool = False,
                 loss_weight: float = 1.0, ignore_index: int = -1):
        if mode != "multiclass":
            raise NotImplementedError(f"LovaszLoss: mode {mode!r} is not ported")
        if per_image or class_seen is not None:
            raise NotImplementedError("LovaszLoss: per_image and class_seen are not ported")
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        valid = target != self.ignore_index
        prob = torch.softmax(pred.float(), dim=-1)
        return lovasz_softmax_flat(prob, torch.where(valid, target, 0), valid) * self.loss_weight
