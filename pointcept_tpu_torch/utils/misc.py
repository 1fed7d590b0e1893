"""Metric helpers of the tester (counterparts in `pointcept_tpu/utils/misc.py`;
parity target: reference `pointcept/utils/misc.py:16,38`). numpy only."""

from __future__ import annotations

import os

import numpy as np


class AverageMeter:
    """The latest value and the running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def intersection_and_union(output, target, K: int, ignore_index: int = -1):
    """Per-class histograms of the intersection, union and target of two
    label arrays of one shape, each [K]; points labelled `ignore_index` in
    `target` count nowhere."""
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1).copy()
    assert output.shape == target.shape
    output[np.where(target == ignore_index)[0]] = ignore_index
    intersection = output[np.where(output == target)[0]]
    area_intersection, _ = np.histogram(intersection, bins=np.arange(K + 1))
    area_output, _ = np.histogram(output, bins=np.arange(K + 1))
    area_target, _ = np.histogram(target, bins=np.arange(K + 1))
    area_union = area_output + area_target - area_intersection
    return area_intersection, area_union, area_target


def make_dirs(path: str):
    os.makedirs(path, exist_ok=True)
