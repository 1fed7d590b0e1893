"""Per-epoch evaluation (counterparts of `SemSegEvaluator`, `ClsEvaluator`,
`InsSegEvaluator`, `ShapeNetPartSegEvaluator` and `PartNetEPartSegEvaluator`
in `pointcept_tpu/engines/hooks/evaluator.py`; parity target: reference
`pointcept/engines/hooks/evaluator.py:118`, `:14`, `:247`, `:648`,
`:790`)."""

from __future__ import annotations

import time

import numpy as np
import torch

from .builder import HOOKS
from .default import HookBase


@HOOKS.register_module()
class SemSegEvaluator(HookBase):
    """After each epoch: the trainer's eval step over the val loader, its
    per-class intersection, union and target summed, then mIoU, mAcc and
    allAcc. Sets ``comm_info["current_metric_value"]`` (mIoU) for the
    checkpoint saver and ``comm_info["eval_result"]`` (with each batch's
    eval-step ms, the copy to the card and the one host read included, and
    the points the static capacities dropped)."""

    metric = "mIoU"  # the checkpoint saver's metric

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader is not None:
            self.eval()

    def eval(self) -> dict:
        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        num_classes = trainer.cfg.data.num_classes
        inter_sum = np.zeros(num_classes)
        union_sum = np.zeros(num_classes)
        target_sum = np.zeros(num_classes)
        losses, batch_ms, overflow = [], [], 0
        for i, batch in enumerate(trainer.val_loader):
            t0 = time.perf_counter()
            res = trainer.eval_step(batch)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            inter_sum += res["intersection"]
            union_sum += res["union"]
            target_sum += res["target"]
            losses.append(res["loss"])
            overflow += res["pool_overflow"] + res["block_overflow"]
            iou = res["intersection"].sum() / (res["union"].sum() + 1e-10)
            acc = res["intersection"].sum() / (res["target"].sum() + 1e-10)
            trainer.logger.info("Test: [{}/{}] Loss {:.4f} Batch iou {:.4f} acc {:.4f}".format(
                i + 1, len(trainer.val_loader), losses[-1], iou, acc))
        iou_class = inter_sum / (union_sum + 1e-10)
        acc_class = inter_sum / (target_sum + 1e-10)
        m_iou = float(np.mean(iou_class))
        m_acc = float(np.mean(acc_class))
        all_acc = float(inter_sum.sum() / (target_sum.sum() + 1e-10))
        trainer.logger.info("Val result: mIoU/mAcc/allAcc {:.4f}/{:.4f}/{:.4f}.".format(m_iou, m_acc, all_acc))
        names = trainer.cfg.data.get("names", [str(i) for i in range(num_classes)])
        for i in range(num_classes):
            trainer.logger.info("Class_{}-{} Result: iou/accuracy {:.4f}/{:.4f}".format(
                i, names[i], iou_class[i], acc_class[i]))
        if trainer.storage is not None:
            trainer.storage.put_scalar("val/loss", float(np.mean(losses)), smoothing_hint=False)
            trainer.storage.put_scalar("val/mIoU", m_iou, smoothing_hint=False)
            trainer.storage.put_scalar("val/mAcc", m_acc, smoothing_hint=False)
            trainer.storage.put_scalar("val/allAcc", all_acc, smoothing_hint=False)
        trainer.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        result = dict(mIoU=m_iou, mAcc=m_acc, allAcc=all_acc, intersection=inter_sum, union=union_sum,
                      target=target_sum, loss=float(np.mean(losses)), batch_ms=batch_ms, overflow=overflow)
        trainer.comm_info["current_metric_value"] = result[self.metric]
        trainer.comm_info["current_metric_name"] = self.metric
        trainer.comm_info["eval_result"] = result
        return result

    def after_train(self):
        self.trainer.logger.info("Best {}: {:.4f}".format(self.metric, self.trainer.best_metric_value))


@HOOKS.register_module()
class ClsEvaluator(SemSegEvaluator):
    """`SemSegEvaluator` over clouds: the trainer's eval step compares each
    valid cloud's argmax class with its ``category``, so intersection,
    union and target count clouds; the checkpoint saver's metric is
    allAcc."""

    metric = "allAcc"


@HOOKS.register_module()
class InsSegEvaluator(HookBase):
    """After each epoch: PointGroup's proposals on every val batch
    (`propose_batch`: the forward and its softmax on the device, one read to
    the host, `propose_instances` there), matched scene by scene against the
    batch's ``instance`` and ``segment`` (`scene_records`,
    `utils.instance_eval`): mAP, AP50 and AP25 over the val set
    (counterpart of the JAX package's; reference `hooks/evaluator.py:247`).
    A batch of several scenes is split into its scenes, each its own record
    (instance ids are per scene; the JAX hook takes a batch as one scene).
    Sets ``comm_info["current_metric_value"]`` (mAP) for the checkpoint
    saver and ``comm_info["eval_result"]`` with each batch's forward ms,
    host clustering ms and proposals a scene, and the points the static
    capacities dropped."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader is not None:
            self.eval()

    def eval(self) -> dict:
        from ...utils.instance_eval import aggregate_ap

        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        model = trainer.model
        model.eval()
        num_classes = trainer.cfg.data.num_classes - sum(1 for i in self.segment_ignore_index if i >= 0)
        records = {c: [] for c in range(num_classes)}
        gt_counts = {c: 0 for c in range(num_classes)}
        losses, batch_ms, forward_ms, host_ms, proposals, overflow = [], [], [], [], [], 0
        scene = 0
        for i, batch in enumerate(trainer.val_loader):
            t0 = time.perf_counter()
            out = propose_batch(model, batch, trainer.device)
            counts = scene_records(*out["proposals"], out["host"], batch["num_scenes"], num_classes,
                                   self.segment_ignore_index, records, gt_counts, scene)
            scene += batch["num_scenes"]
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            forward_ms.append(out["forward_ms"])
            host_ms.append(out["cluster_ms"])
            proposals += counts
            losses.append(out["loss"])
            overflow += out["dropped"]
            trainer.logger.info(f"Test: [{i + 1}/{len(trainer.val_loader)}] Loss {losses[-1]:.4f} "
                                f"proposals {counts} clustering {host_ms[-1]:.1f} ms")
        result = aggregate_ap(records, gt_counts, num_classes)
        trainer.logger.info("Val result: mAP/AP50/AP25 {:.4f}/{:.4f}/{:.4f}".format(
            result["mAP"], result["AP50"], result["AP25"]))
        if trainer.storage is not None:
            trainer.storage.put_scalar("val/loss", float(np.mean(losses)), smoothing_hint=False)
            for name in ("mAP", "AP50", "AP25"):
                trainer.storage.put_scalar(f"val/{name}", result[name], smoothing_hint=False)
        trainer.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        trainer.comm_info["current_metric_value"] = result["mAP"]
        trainer.comm_info["current_metric_name"] = "mAP"
        result.update(loss=float(np.mean(losses)), batch_ms=batch_ms, forward_ms=forward_ms, cluster_ms=host_ms,
                      proposals=proposals, overflow=overflow, gt_instances=sum(gt_counts.values()))
        trainer.comm_info["eval_result"] = result
        return result

    def after_train(self):
        self.trainer.logger.info("Best {}: {:.4f}".format("mAP", self.trainer.best_metric_value))


@torch.no_grad()
def propose_batch(model, arrays: dict, device) -> dict:
    """PointGroup's proposals of one collated batch: the forward on
    `device`, its softmax, and one read to the host of the probabilities,
    offsets, loss, dropped points and the batch's coord, batch ids,
    ``instance`` and ``segment`` (``host``); then `propose_instances` there
    (``proposals``: masks over the batch's rows, classes, scores), with the
    forward's ms (its read included) and the clustering's."""
    from ..train import make_point_batch

    t0 = time.perf_counter()
    pb = make_point_batch(arrays, arrays["num_scenes"], device=device)
    res = model(pb)
    prob = torch.softmax(res["seg_logits"].float(), dim=-1)
    dropped = sum(v for vs in res["diagnostics"].values() for v in vs)
    loss = res.get("loss", torch.zeros((), device=prob.device))
    loss, dropped = torch.stack([loss.float(), torch.as_tensor(dropped, device=prob.device).float()]).tolist()
    host = {k: v.cpu().numpy() for k, v in dict(coord=pb.coord, prob=prob, bias=res["bias_pred"].float(),
                                                 batch=pb.batch, instance=pb.instance, segment=pb.segment).items()}
    t1 = time.perf_counter()
    proposals = model.propose_instances(host["coord"], host["bias"], host["prob"], host["batch"], host["batch"] >= 0)
    return dict(host=host, proposals=proposals, loss=loss, dropped=int(dropped), forward_ms=(t1 - t0) * 1e3,
                cluster_ms=(time.perf_counter() - t1) * 1e3)


def scene_records(masks, classes, scores, host: dict, num_scenes: int, num_classes: int, segment_ignore,
                  records: dict, gt_counts: dict, first_scene: int) -> list:
    """Add each scene of a batch (rows of ``host["batch"]`` equal to its
    index) to `records` (class -> (score, IoUs, scene id)) and `gt_counts`:
    its proposals (a proposal's points lie in one scene: the clustering
    never crosses scenes) against its ``instance`` / ``segment``. Returns
    the proposals a scene.

    `evaluate_scene` takes classes with the ignored ones removed (a GT
    segment above k ignored classes is class ``segment - k``), so the
    proposals' classes, argmaxes over every class, are shifted the same way
    (the JAX hook and tester pass them unshifted: ScanNet's class c meets
    GT class c + 2, and a perfect prediction scores AP 0)."""
    from ...utils.instance_eval import evaluate_scene

    vacancy = np.asarray([i for i in segment_ignore if i >= 0])
    classes = classes - np.greater(classes[:, None], vacancy[None]).sum(axis=1)
    counts = []
    for s in range(num_scenes):
        rows = host["batch"] == s
        mine = masks[:, rows].any(axis=1)
        recs, gts = evaluate_scene(masks[mine][:, rows], classes[mine], scores[mine], host["instance"][rows],
                                   host["segment"][rows], num_classes, segment_ignore)
        for c, lst in recs.items():
            records.setdefault(c, []).extend((score, ious, first_scene + s) for score, ious in lst)
        for c, cnt in gts.items():
            gt_counts[c] = gt_counts.get(c, 0) + cnt
        counts.append(int(mine.sum()))
    return counts


class _PartSegEvaluator(HookBase):
    """After each epoch: the eval forward of every val batch, its logits and
    labels read to the host, then `scene_ious` of each shape the batch
    holds (a scene whose ``key`` is -1 pads the batch; a batch without
    ``key`` raises, where the JAX hooks score every shape as category 0).
    Sets ``comm_info["current_metric_value"]`` (`metric`) and
    ``comm_info["eval_result"]`` (with each batch's ms and the points the
    static capacities dropped)."""

    key = metric = ""

    def after_epoch(self):
        if self.trainer.cfg.get("evaluate", True) and self.trainer.val_loader is not None:
            self.eval()

    def reset(self, dataset):
        raise NotImplementedError

    def scene_ious(self, dataset, label: int, logits: np.ndarray, segment: np.ndarray):
        raise NotImplementedError

    def summary(self, dataset) -> dict:
        raise NotImplementedError

    def eval(self) -> dict:
        from ..train import make_point_batch

        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        model, dataset = trainer.model, trainer.val_loader.dataset
        model.eval()
        self.reset(dataset)
        batch_ms, overflow = [], 0
        for batch in trainer.val_loader:
            if self.key not in batch:
                raise ValueError(f"{type(self).__name__}: the val batches carry no `{self.key}`; keep it in the "
                                 "val pipeline's Collect keys")
            t0 = time.perf_counter()
            pb = make_point_batch(batch, batch["num_scenes"], device=trainer.device)
            with torch.no_grad():
                res = model(pb)
            dropped = sum(v for vs in res["diagnostics"].values() for v in vs)
            logits, scene, segment = (t.cpu().numpy() for t in (res["seg_logits"].float(), pb.batch, pb.segment))
            overflow += int(dropped)
            for s, label in enumerate(np.asarray(batch[self.key]).reshape(-1)):
                if label >= 0:
                    sel = scene == s
                    self.scene_ious(dataset, int(label), logits[sel], segment[sel])
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        result = self.summary(dataset)
        trainer.logger.info("Val result: " + " ".join(f"{k} {v:.4f}" for k, v in result.items()))
        if trainer.storage is not None:
            for k, v in result.items():
                trainer.storage.put_scalar(f"val/{k}", v, smoothing_hint=False)
        trainer.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        trainer.comm_info["current_metric_value"] = result[self.metric]
        trainer.comm_info["current_metric_name"] = self.metric
        result.update(batch_ms=batch_ms, overflow=overflow)
        trainer.comm_info["eval_result"] = result
        return result

    def after_train(self):
        self.trainer.logger.info("Best {}: {:.4f}".format(self.metric, self.trainer.best_metric_value))


@HOOKS.register_module()
class ShapeNetPartSegEvaluator(_PartSegEvaluator):
    """ShapeNet-Part (counterpart of the JAX package's hook; reference
    `hooks/evaluator.py:648`): each shape's argmax over its category's part
    range, its mean part IoU (`engines.test.part_ious`: 1 for a part
    neither the labels nor the prediction hold); ``ins.mIoU`` over the
    shapes (the checkpoint saver's metric), ``cat.mIoU`` over the categories
    that have shapes. A shape's category is the batch's ``category``."""

    key, metric = "category", "ins.mIoU"

    def reset(self, dataset):
        self.per_cat = {}

    def scene_ious(self, dataset, label, logits, segment):
        from ..test import part_ious

        parts = dataset.category2part[dataset.categories[label]]
        self.per_cat.setdefault(label, []).append(float(np.mean(part_ious(logits, segment, parts))))

    def summary(self, dataset) -> dict:
        shapes = [v for lst in self.per_cat.values() for v in lst]
        return {"ins.mIoU": float(np.mean(shapes)) if shapes else 0.0,
                "cat.mIoU": float(np.mean([np.mean(v) for v in self.per_cat.values()])) if shapes else 0.0}


@HOOKS.register_module()
class PartNetEPartSegEvaluator(_PartSegEvaluator):
    """PartNetE (counterpart of the JAX package's hook; reference
    `hooks/evaluator.py:790`): for each part of a sample's category but
    "other" (the first), where the labels or the argmax hold it, its IoU
    (labels shifted by one) into that part's running mean; ``part.mIoU``
    over the parts seen (the checkpoint saver's metric), ``cat.mIoU`` over
    the categories' means. A sample's category is the batch's
    ``cls_token``."""

    key, metric = "cls_token", "part.mIoU"

    def reset(self, dataset):
        self.iou_sum = np.zeros(int(sum(dataset.num_parts)), np.float64)
        self.iou_cnt = np.zeros_like(self.iou_sum)

    def scene_ious(self, dataset, label, logits, segment):
        pred = logits.argmax(-1)
        for part_id in dataset.category2part[dataset.categories[label]][1:]:
            gid = part_id + 1
            union = ((pred == gid) | (segment == gid)).sum()
            if union:
                self.iou_sum[part_id] += ((pred == gid) & (segment == gid)).sum() / union
                self.iou_cnt[part_id] += 1

    def summary(self, dataset) -> dict:
        seen = self.iou_cnt > 0
        part = np.where(seen, self.iou_sum / np.maximum(self.iou_cnt, 1), 0.0)
        cats = [np.mean([part[p] for p in ids]) for ids in
                ([p for p in dataset.category2part[c][1:] if seen[p]] for c in dataset.categories) if ids]
        return {"part.mIoU": float(part[seen].mean()) if seen.any() else 0.0,
                "cat.mIoU": float(np.mean(cats)) if cats else 0.0}
