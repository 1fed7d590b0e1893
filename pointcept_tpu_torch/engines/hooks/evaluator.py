"""Per-epoch semantic-segmentation evaluation (counterpart of `SemSegEvaluator`
in `pointcept_tpu/engines/hooks/evaluator.py`; parity target: reference
`pointcept/engines/hooks/evaluator.py:118`)."""

from __future__ import annotations

import time

import numpy as np

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
        trainer.comm_info["current_metric_value"] = m_iou
        trainer.comm_info["current_metric_name"] = "mIoU"
        result = dict(mIoU=m_iou, mAcc=m_acc, allAcc=all_acc, intersection=inter_sum, union=union_sum,
                      target=target_sum, loss=float(np.mean(losses)), batch_ms=batch_ms, overflow=overflow)
        trainer.comm_info["eval_result"] = result
        return result

    def after_train(self):
        self.trainer.logger.info("Best {}: {:.4f}".format("mIoU", self.trainer.best_metric_value))
