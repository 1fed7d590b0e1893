"""Loss registry and the criteria sum (counterpart of
`pointcept_tpu/models/losses/builder.py`): a config list of loss dicts,
summed, each loss applying its own ``loss_weight``."""

from __future__ import annotations

from ...utils.registry import Registry

LOSSES = Registry("losses")


class Criteria:
    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.criteria = [LOSSES.build(c) for c in self.cfg]

    def __call__(self, pred, target):
        if len(self.criteria) == 0:
            return pred
        total = 0.0
        for c in self.criteria:
            total = total + c(pred, target)
        return total


def build_criteria(cfg):
    return Criteria(cfg)
