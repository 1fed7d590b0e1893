"""Instance segmentation's AP (mAP over IoU 0.5:0.95, AP50, AP25): the
counterpart of `pointcept_tpu/utils/instance_eval.py`, equal to it exactly.

Per class and IoU threshold, predictions are matched greedily in score order
to the unmatched ground-truth instance of best IoU above the threshold;
precision is made monotone and integrated over recall. Ground-truth
instances whose class is in `segment_ignore` are left out, and the classes
above the ignored ones shift down by their count. No minimum instance size
and no rule for predictions over ignored points (ScanNet's
`evaluate_semantic_instance.py` has both): the JAX package's protocol, kept
as it is so that the two packages' AP agree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)


def evaluate_scene(pred_masks, pred_classes, pred_scores, gt_instance, gt_segment, num_classes, segment_ignore):
    """One scene's records: ``{class: [(score, IoU with each GT instance of
    the scene, 0 where the class differs)]}`` in descending score order, and
    the GT instances a class. `pred_masks` [P, N] bool; `gt_instance` [N]
    (-1: none); `gt_segment` [N]."""
    records = {c: [] for c in range(num_classes)}
    gt_counts = {c: 0 for c in range(num_classes)}
    gt_ids = np.unique(gt_instance)
    gt_ids = gt_ids[gt_ids >= 0]
    gt_masks, gt_cls = [], []
    vacancy = [i for i in segment_ignore if i >= 0]
    for g in gt_ids:
        m = gt_instance == g
        seg = gt_segment[m][0]
        if seg in segment_ignore or seg < 0:
            continue
        cls = int(seg - np.greater(seg, vacancy).sum())
        if not 0 <= cls < num_classes:
            continue
        gt_masks.append(m)
        gt_cls.append(cls)
        gt_counts[cls] += 1
    gt_masks = np.stack(gt_masks) if gt_masks else np.zeros((0, gt_instance.shape[0]), bool)
    gt_cls = np.asarray(gt_cls, np.int32)

    for p in np.argsort(-pred_scores):
        cls = int(pred_classes[p])
        pm = pred_masks[p]
        ious = np.zeros(len(gt_cls))
        for gi in range(len(gt_cls)):
            if gt_cls[gi] != cls:
                continue
            inter = np.logical_and(pm, gt_masks[gi]).sum()
            union = np.logical_or(pm, gt_masks[gi]).sum()
            ious[gi] = inter / union if union > 0 else 0.0
        records.setdefault(cls, []).append((float(pred_scores[p]), ious))
    return records, gt_counts


def aggregate_ap(all_records: Dict[int, List], all_gt_counts: Dict[int, int], num_classes: int) -> dict:
    """AP over the scenes: ``all_records[c]`` a list of (score, IoUs, scene
    id), ``all_gt_counts[c]`` the GT instances of class c. Returns mAP (the
    mean over the thresholds 0.5-0.9), AP50, AP25 and the AP of each
    threshold; a class without GT instances is left out of the means."""
    ap_per_overlap = {}
    for t in OVERLAPS:
        aps = []
        for c in range(num_classes):
            if all_gt_counts.get(c, 0) == 0:
                continue
            scored = sorted(all_records.get(c, []), key=lambda r: -r[0])
            matched_gt = set()
            tp, fp = [], []
            for score, ious, scene_id in scored:
                best, best_gi = 0.0, -1
                for gi, iou in enumerate(ious):
                    if iou >= t and iou > best and (scene_id, gi) not in matched_gt:
                        best, best_gi = iou, gi
                if best_gi >= 0:
                    matched_gt.add((scene_id, best_gi))
                    tp.append(1)
                    fp.append(0)
                else:
                    tp.append(0)
                    fp.append(1)
            tp = np.cumsum(tp)
            fp = np.cumsum(fp)
            recall = tp / all_gt_counts[c]
            precision = tp / np.maximum(tp + fp, 1e-9)
            mrec = np.concatenate([[0], recall, [recall[-1] if len(recall) else 0]])
            mpre = np.concatenate([[1 if len(precision) else 0], precision, [0]])
            for i in range(len(mpre) - 2, -1, -1):
                mpre[i] = max(mpre[i], mpre[i + 1])
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            aps.append(float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])) if len(idx) else 0.0)
        ap_per_overlap[round(float(t), 2)] = float(np.mean(aps)) if aps else 0.0
    strict = [v for k, v in ap_per_overlap.items() if k >= 0.5]
    return dict(mAP=float(np.mean(strict)) if strict else 0.0, AP50=ap_per_overlap.get(0.5, 0.0),
                AP25=ap_per_overlap.get(0.25, 0.0), per_overlap=ap_per_overlap)
