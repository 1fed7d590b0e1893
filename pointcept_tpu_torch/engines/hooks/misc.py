"""Core hooks: timing, logging, checkpoints, and the schedules of Sonata's
pretraining (counterparts of `pointcept_tpu/engines/hooks/misc.py`; parity
targets: reference `pointcept/engines/hooks/misc.py` IterationTimer `:34`,
InformationWriter `:81`, CheckpointSaver `:169`, CheckpointLoader `:230`,
PreciseEvaluator `:278`, RuntimeProfilerV2 `:427`, WeightDecaySchedular
`:500`).

Checkpoints are the reference Pointcept format, not the JAX package's Orbax
directories: ``save_path/model/model_last.pth`` is a `torch.save` of
``epoch``, ``state_dict`` (the reference parameter names), ``optimizer``,
``scheduler`` and ``best_metric_value``; ``model_best.pth`` is its copy at the
best metric, ``epoch_{n}.pth`` its copy every `save_freq` epochs.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from collections import OrderedDict

import numpy as np
import torch

from ...utils import comm
from ...utils.scheduler import CosineScheduler
from ...utils.timer import Timer
from .builder import HOOKS
from .default import HookBase


@HOOKS.register_module()
class IterationTimer(HookBase):
    """``data_time`` (the wait for the loader) before each step and
    ``batch_time`` (the loader's wait and the step) after it, into the
    trainer's storage. The step reads its loss on the host, so batch_time
    includes the card's work."""

    def __init__(self, warmup_iter=2):
        self._warmup_iter = warmup_iter
        self._start_time = time.perf_counter()
        self._iter_timer = Timer()
        self._remain_iter = 0

    def before_train(self):
        self._start_time = time.perf_counter()
        self._remain_iter = (self.trainer.max_epoch - self.trainer.start_epoch) * len(self.trainer.train_loader)

    def before_epoch(self):
        self._iter_timer.reset()

    def before_step(self):
        self.trainer.storage.put_scalar("data_time", self._iter_timer.seconds())

    def after_step(self):
        batch_time = self._iter_timer.seconds()
        self._iter_timer.reset()
        storage = self.trainer.storage
        storage.put_scalar("batch_time", batch_time)
        self._remain_iter -= 1
        remain_time = self._remain_iter * storage.history("batch_time").avg(50)
        t_m, t_s = divmod(remain_time, 60)
        t_h, t_m = divmod(t_m, 60)
        if "iter_info" in self.trainer.comm_info:
            self.trainer.comm_info["iter_info"] += (
                "Data {:.3f} ({:.3f}) Batch {:.3f} ({:.3f}) Remain {:02d}:{:02d}:{:02d} ".format(
                    storage.history("data_time").latest(), storage.history("data_time").avg(50),
                    storage.history("batch_time").latest(), storage.history("batch_time").avg(50),
                    int(t_h), int(t_m), int(t_s)))


@HOOKS.register_module()
class InformationWriter(HookBase):
    """The per-step log line, and every scalar of the step (loss, lr, the
    overflow counters, data_time, batch_time) as one JSON line of
    ``save_path/metrics.jsonl``, floats at full precision. It takes the
    place of the JAX package's TensorBoard writer; wandb is not ported."""

    def __init__(self):
        self.curr_iter = 0
        self._file = None

    def before_train(self):
        self.curr_iter = self.trainer.start_epoch * len(self.trainer.train_loader)
        if comm.is_main_process():
            self._file = open(os.path.join(self.trainer.cfg.save_path, "metrics.jsonl"), "a")

    def before_step(self):
        self.curr_iter += 1
        self.trainer.comm_info["iter_info"] = "Train: [{}/{}][{}/{}] ".format(
            self.trainer.epoch + 1, self.trainer.max_epoch, self.trainer.comm_info["iter"] + 1,
            len(self.trainer.train_loader))

    def after_step(self):
        metrics = self.trainer.comm_info.get("metrics", {})
        info = "".join("{} {:.4f} ".format(k.capitalize(), float(v)) for k, v in metrics.items())
        lr = self.trainer.comm_info.get("lr", 0.0)
        self.trainer.comm_info["iter_info"] += info + "Lr: {:.5f}".format(lr)
        self.trainer.logger.info(self.trainer.comm_info["iter_info"])
        self.trainer.comm_info["iter_info"] = ""
        storage = self.trainer.storage
        if self._file is not None:
            row = {k: v for k, (v, itr) in storage.latest().items() if itr == storage.iter}
            row.update(iter=self.curr_iter, epoch=self.trainer.epoch + 1)
            self._file.write(json.dumps(row, sort_keys=True) + "\n")
            self._file.flush()
        storage.step()

    def after_train(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _link_or_copy(src: str, dst: str) -> None:
    """`dst` as a hard link of `src` (a copy where the file system has no
    links), replaced atomically. `_atomic_save` replaces `src` by a new
    file, so a link keeps the checkpoint it was made from, and no
    checkpoint is written twice."""
    tmp = dst + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


@HOOKS.register_module()
class CheckpointSaver(HookBase):
    """After each epoch (after the evaluator): `model_last.pth`, and as hard
    links of it `model_best.pth` when the metric improved and
    `epoch_{n}.pth` every `save_freq` epochs (the reference copies them)."""

    def __init__(self, save_freq=None):
        self.save_freq = save_freq

    def after_epoch(self):
        if not comm.is_main_process():
            return
        trainer = self.trainer
        is_best = False
        value = trainer.comm_info.get("current_metric_value", 0)
        name = trainer.comm_info.get("current_metric_name", "n/a")
        if value > trainer.best_metric_value:
            trainer.best_metric_value = value
            is_best = True
            trainer.logger.info(f"Best validation {name} updated to: {value:.4f}")
        trainer.logger.info(f"Currently Best {name}: {trainer.best_metric_value:.4f}")
        model_dir = os.path.join(trainer.cfg.save_path, "model")
        os.makedirs(model_dir, exist_ok=True)
        last = os.path.join(model_dir, "model_last.pth")
        trainer.logger.info(f"Saving checkpoint to: {last}")
        _atomic_save(dict(epoch=trainer.epoch + 1, state_dict=trainer.model.state_dict(),
                          optimizer=trainer.optimizer.state_dict(), scheduler=trainer.scheduler.state_dict(),
                          best_metric_value=trainer.best_metric_value), last)
        if is_best:
            _link_or_copy(last, os.path.join(model_dir, "model_best.pth"))
        if self.save_freq and (trainer.epoch + 1) % self.save_freq == 0:
            _link_or_copy(last, os.path.join(model_dir, f"epoch_{trainer.epoch + 1}.pth"))


def remap_state_dict(state_dict, keywords: str = "", replacement=None) -> "OrderedDict":
    """A checkpoint's state dict under the model's names, as the reference
    loader maps them: a ``module.`` prefix (a DDP checkpoint) is stripped and
    `keywords` in a name becomes `replacement`."""
    replacement = keywords if replacement is None else replacement
    out = OrderedDict()
    for key, value in state_dict.items():
        if not key.startswith("module."):
            key = "module." + key
        if keywords in key:
            key = key.replace(keywords, replacement)
        out[key[len("module."):]] = value
    return out


@HOOKS.register_module()
class CheckpointLoader(HookBase):
    """Before training, from ``cfg.weight``: the weights (a checkpoint's
    ``state_dict``, or a bare state dict) through `remap_state_dict`, loaded
    with `strict`; with ``cfg.resume`` also the optimizer, the scheduler, the
    start epoch and the best metric. The missing and the unexpected keys are
    logged (a probe on a Sonata checkpoint: its seg head missing, the
    teacher, the SSL heads and the mask token unexpected); a tensor whose
    shape differs from the model's raises, naming it (`load_state_dict`
    does, `strict` or not)."""

    def __init__(self, keywords="", replacement=None, strict=False):
        self.keywords = keywords
        self.replacement = replacement if replacement is not None else keywords
        self.strict = strict

    def before_train(self):
        trainer, cfg = self.trainer, self.trainer.cfg
        trainer.logger.info("=> Loading checkpoint & weight ...")
        if not (cfg.get("weight") and os.path.isfile(cfg.weight)):
            trainer.logger.info(f"No weight found at: {cfg.get('weight')}")
            return
        trainer.logger.info(f"Loading weight at: {cfg.weight}")
        # the trainer's own checkpoints: tensors, numbers and the optimizer's
        # and scheduler's state dicts
        checkpoint = torch.load(cfg.weight, map_location=trainer.device, weights_only=False)
        state = remap_state_dict(checkpoint.get("state_dict", checkpoint), self.keywords, self.replacement)
        info = trainer.model.load_state_dict(state, strict=self.strict)
        trainer.logger.info(f"Missing keys: {info.missing_keys}")
        trainer.logger.info(f"Unexpected keys: {info.unexpected_keys}")
        trainer.comm_info["load_info"] = dict(missing=list(info.missing_keys), unexpected=list(info.unexpected_keys))
        if cfg.get("resume"):
            trainer.start_epoch = int(checkpoint["epoch"])
            trainer.best_metric_value = float(checkpoint["best_metric_value"])
            trainer.optimizer.load_state_dict(checkpoint["optimizer"])
            trainer.scheduler.load_state_dict(checkpoint["scheduler"])
            trainer.logger.info(f"Resuming train at eval epoch: {trainer.start_epoch}")


@HOOKS.register_module()
class PreciseEvaluator(HookBase):
    """After training: the config's tester (``cfg.test``) on the trainer's
    model, with ``model_best.pth``'s weights loaded into it first unless
    `test_last` (the last epoch's weights as they are); the tester's result
    goes to ``comm_info["precise_result"]``."""

    def __init__(self, test_last: bool = False):
        self.test_last = test_last

    def after_train(self):
        from ..test import TESTERS

        trainer, cfg = self.trainer, self.trainer.cfg
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Precise Evaluation >>>>>>>>>>>>>>>>")
        best = os.path.join(cfg.save_path, "model", "model_best.pth")
        if self.test_last or not os.path.isfile(best):
            trainer.logger.info("=> Testing on model_last ...")
        else:
            trainer.logger.info("=> Testing on model_best ...")
            checkpoint = torch.load(best, map_location=trainer.device, weights_only=False)
            trainer.model.load_state_dict(remap_state_dict(checkpoint["state_dict"]), strict=True)
        tester = TESTERS.build(dict(cfg.test, cfg=cfg, model=trainer.model, device=trainer.device))
        trainer.comm_info["precise_result"] = tester.test()


@HOOKS.register_module()
class RuntimeProfilerV2(HookBase):
    """`torch.profiler` over the first epoch's steps in cycles of `wait`,
    `warmup` and `active` steps, `repeat` cycles (the reference's
    schedule): each cycle's profiler starts at its first warmup step, keeps
    its active steps and writes them as a Chrome trace to
    ``save_path/profile/cycle{n}/trace.json``, the card's kernels too on a
    CUDA device. Each step of a window is a ``train_step {iter}`` span."""

    def __init__(self, wait: int = 1, warmup: int = 1, active: int = 2, repeat: int = 1):
        self.wait, self.warmup, self.active, self.repeat = wait, warmup, active, repeat
        self._cycle_len = wait + warmup + active
        self._prof = self._span = None

    def before_step(self):
        trainer = self.trainer
        cycle, pos = divmod(trainer.comm_info["iter"], self._cycle_len)
        if trainer.epoch != 0 or cycle >= self.repeat:
            return
        if pos == self.wait:
            trace_dir = os.path.join(trainer.cfg.save_path, "profile", f"cycle{cycle}")
            os.makedirs(trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if trainer.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities,
                schedule=torch.profiler.schedule(wait=0, warmup=self.warmup, active=self.active, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(os.path.join(trace_dir, "trace.json")))
            self._prof.start()
            trainer.logger.info(f"RuntimeProfilerV2: cycle {cycle} -> {trace_dir}")
        if self._prof is not None:
            self._span = torch.profiler.record_function(f"train_step {trainer.comm_info['iter']}")
            self._span.__enter__()

    def after_step(self):
        if self._prof is None:
            return
        self._span.__exit__(None, None, None)
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)
        self._prof.step()
        if self.trainer.comm_info["iter"] % self._cycle_len == self._cycle_len - 1:
            self._prof.stop()
            self._prof = None
            self.trainer.logger.info("RuntimeProfilerV2: cycle complete")

    def after_epoch(self):
        if self._prof is not None:  # an epoch shorter than the cycle
            self._prof.stop()
            self._prof = None


@HOOKS.register_module()
class SonataHook(HookBase):
    """The per-step hyperparameters of Sonata's pretraining (mask size, mask
    ratio, teacher temperature, the teacher's EMA momentum), each a
    `CosineScheduler` over the run's steps from the model's fields, into
    ``comm_info["model_hyper"]`` (the train step hands them to the forward
    and the EMA) and the storage as ``params/{name}``. A resumed run starts
    each schedule at ``start_epoch * len(train_loader)``."""

    def before_train(self):
        model = self.trainer.model
        steps = len(self.trainer.train_loader)
        total_steps = steps * self.trainer.max_epoch
        curr = self.trainer.start_epoch * steps

        def sched(start, base, warmup_ratio=0.0, final=None):
            s = CosineScheduler(base_value=base, final_value=base if final is None else final,
                                total_steps=total_steps, warmup_steps=int(total_steps * warmup_ratio),
                                start_warmup_value=start)
            s.iter = curr
            return s

        self._schedules = dict(
            mask_size=sched(model.mask_size_start, model.mask_size_base, model.mask_size_warmup_ratio),
            mask_ratio=sched(model.mask_ratio_start, model.mask_ratio_base, model.mask_ratio_warmup_ratio),
            teacher_temp=sched(model.teacher_temp_start, model.teacher_temp_base, model.teacher_temp_warmup_ratio),
            momentum=sched(model.momentum_base, model.momentum_base, 0.0, final=model.momentum_final),
        )

    def before_step(self):
        hyper = {name: float(s.step()) for name, s in self._schedules.items()}
        self.trainer.comm_info["model_hyper"] = hyper
        for name, value in hyper.items():
            self.trainer.storage.put_scalar(f"params/{name}", value, smoothing_hint=False)


@HOOKS.register_module()
class WeightDecaySchedular(HookBase):
    """A cosine weight-decay schedule over the epochs: before each epoch
    every param group's ``weight_decay`` becomes ``final + (base - final) *
    (1 + cos(pi * epoch / max_epoch)) / 2``, as the reference sets it. (The
    JAX hook rebuilds its optimizer instead, and loses the teacher mask and
    the clip on the way.)"""

    def __init__(self, base_value=0.05, final_value=0.05):
        self.base_value = base_value
        self.final_value = final_value

    def value(self, epoch: int) -> float:
        t = epoch / max(self.trainer.max_epoch, 1)
        return float(self.final_value + 0.5 * (self.base_value - self.final_value) * (1 + np.cos(np.pi * t)))

    def before_epoch(self):
        wd = self.value(self.trainer.epoch)
        for group in self.trainer.optimizer.param_groups:
            group["weight_decay"] = wd
        self.trainer.storage.put_scalar("params/weight_decay", wd, smoothing_hint=False)
        self.trainer.logger.info(f"WeightDecaySchedular: wd -> {wd:.5f}")
