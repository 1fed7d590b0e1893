"""Batch assembly, the train step and the hook-driven trainer (counterparts of
`make_point_batch`, `build_train_step`, `TrainerBase` and `Trainer` in
`pointcept_tpu/engines/train.py`; parity target: reference
`pointcept/engines/train.py:38-357`).

The trainer runs in one process on one device: no mesh, no DDP. Its
structure is the JAX trainer's (hooks, `comm_info`, `EventStorage`, the
epoch loop compressed by `eval_epoch`), so the hooks port one to one. The
JAX trainer's host geometry (`host_geometry`, `geometry_plan`) is not
ported: the port builds the geometry on the device and ignores the key.

Point Prompt Training's `MultiDatasetTrainer` takes its train batches from
`MultiDatasetDataloader` (the sub-datasets interleaved by ratio, one
dataset a batch); each batch's ``condition`` goes into its PointBatch, and
a config whose pipelines add a condition the model does not know is refused
before anything is built.

Self-distillation models (Sonata) train through the same step: their
multi-view batches go in as `make_view_inputs`, the hyperparameters a hook
schedules (``comm_info["model_hyper"]``) go to the forward, and after the
optimizer step the model's `ema_update` moves its teacher (whose
parameters no optimizer holds: they do not require gradients).
"""

from __future__ import annotations

import math
import os
from functools import partial
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..datasets import DataLoader, build_dataset, point_collate_fn
from ..datasets.dataloader import MultiDatasetDataloader
from ..models import apply_amp_policy, build_model
from ..models.utils.structure import PointBatch, grid_bits
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.events import EventStorage, ExceptionWriter
from ..utils.logger import get_root_logger
from ..utils.optimizer import build_optimizer
from ..utils.registry import Registry
from ..utils.scheduler import build_scheduler
from .hooks import build_hooks

TRAINERS = Registry("trainers")


def _put(arrays, key: str, dtype, device):
    a = arrays.get(key)
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(device, dtype, non_blocking=True)


def make_point_batch(arrays: Dict[str, np.ndarray], num_scenes: int, device=None, prefix: str = "",
                     condition: Optional[str] = None) -> PointBatch:
    """Collated arrays (numpy or tensors) -> PointBatch on `device` (the GPU
    unless the caller names another; raises when no GPU is present and none
    is named), from the keys ``{prefix}coord``, ... (a classifier's batch
    brings ``category``, one a scene). Copies from pinned host
    tensors do not wait for the card. The grid's depth (`grid_bits`) is
    read from the collated grid while it is still on the host. The batch's
    `condition` (PPT) is the argument's, else the arrays' ``condition``."""
    device = resolve_device(device)
    return PointBatch(
        coord=_put(arrays, prefix + "coord", torch.float32, device),
        feat=_put(arrays, prefix + "feat", torch.float32, device),
        grid_coord=_put(arrays, prefix + "grid_coord", torch.int32, device),
        batch=_put(arrays, prefix + "batch", torch.int32, device),
        segment=_put(arrays, prefix + "segment", torch.int32, device),
        origin_coord=_put(arrays, prefix + "origin_coord", torch.float32, device),
        instance=_put(arrays, prefix + "instance", torch.int32, device),
        instance_centroid=_put(arrays, prefix + "instance_centroid", torch.float32, device),
        category=_put(arrays, prefix + "category", torch.int32, device),
        num_scenes=num_scenes,
        grid_depth=grid_bits(arrays.get(prefix + "grid_coord")),
        condition=condition if condition is not None else arrays.get("condition"),
    )


VIEW_PREFIXES = ("global", "local")


def make_view_inputs(arrays: Dict[str, np.ndarray], num_scenes: int, device=None) -> dict:
    """A collated multi-view batch -> Sonata's inputs: a PointBatch of each
    view set (``global``, ``local``; one view id a row, `num_scenes` the
    scenes, which the model multiplies by its views) and its
    ``{prefix}_origin_coord``."""
    device = resolve_device(device)
    data = {}
    for prefix in VIEW_PREFIXES:
        if f"{prefix}_coord" in arrays:
            data[prefix] = make_point_batch(arrays, num_scenes, device, prefix=f"{prefix}_")
            data[f"{prefix}_origin_coord"] = data[prefix].origin_coord
    return data


def make_inputs(arrays: Dict[str, np.ndarray], device=None):
    """A collated batch -> the model's input: a PointBatch, or the view
    inputs of a multi-view batch."""
    if "global_coord" in arrays:
        return make_view_inputs(arrays, arrays["num_scenes"], device)
    return make_point_batch(arrays, arrays["num_scenes"], device)


def _total(values, device) -> torch.Tensor:
    return torch.stack(list(values)).sum() if values else torch.zeros((), dtype=torch.int32, device=device)


def build_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
                     clip_grad: Optional[float] = None) -> Callable:
    """One optimisation step on one device: forward in train mode (the
    segmentor's summed criteria, or an SSL model's losses), backward,
    optional clip of the global gradient norm, the optimizer step, one
    scheduler step, then the model's `ema_update` where it has one (with
    ``hyper["momentum"]``).

    Returns ``step(inputs, generator, hyper=None) -> {"loss",
    "pool_overflow", "block_overflow", and the model's named losses
    "*_loss"}``, all 0-d tensors on the model's device: the step itself
    never waits for the card, the caller reads the scalars when it wants
    them. The overflow counters sum over every forward of the step.
    `generator` draws the order shuffles and drop-path masks (and an SSL
    model's mask scores); `hyper` goes to the forward. The parameters'
    ``.grad`` hold the step's gradients until the next step."""
    ema_update = getattr(model, "ema_update", None)

    def step(inputs, generator: torch.Generator, hyper: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        res = model(inputs, generator=generator) if hyper is None else model(inputs, generator=generator,
                                                                               hyper=hyper)
        res["loss"].backward()
        if clip_grad is not None:
            nn.utils.clip_grad_norm_(model.parameters(), clip_grad)
        optimizer.step()
        scheduler.step()
        if ema_update is not None:
            ema_update((hyper or {}).get("momentum"))
        diag, device = res["diagnostics"], res["loss"].device
        out = {"loss": res["loss"].detach(), "pool_overflow": _total(diag["pool_overflow"], device),
               "block_overflow": _total(diag["block_overflow"], device)}
        out.update({k: v.detach() for k, v in res.items() if k.endswith("_loss")})
        return out

    return step


def step_seed(shared_seed: int, global_step: int) -> int:
    """The seed of the generator of one train step: the run's shared seed
    and the global step (as the JAX trainer folds the step into its key),
    so a resumed run draws the same order shuffles and drop-path masks
    without any saved generator state."""
    return (int(shared_seed) * 1_000_003 + int(global_step)) % (2**63)


class TrainerBase:
    def __init__(self):
        self.hooks = []
        self.epoch = 0
        self.start_epoch = 0
        self.max_epoch = 0
        self.comm_info: Dict[str, Any] = dict()
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks_cfg) -> None:
        hooks = build_hooks(hooks_cfg) if hooks_cfg else []
        for h in hooks:
            h.trainer = self
        self.hooks = hooks

    def _call_hooks(self, name):
        for h in self.hooks:
            getattr(h, name)()

    def before_train(self):
        self._call_hooks("before_train")

    def before_epoch(self):
        self._call_hooks("before_epoch")

    def before_step(self):
        self._call_hooks("before_step")

    def run_step(self):
        raise NotImplementedError

    def after_step(self):
        self._call_hooks("after_step")

    def after_epoch(self):
        self._call_hooks("after_epoch")
        self.storage.reset_histories()

    def after_train(self):
        if self.comm_info.get("terminate", False):
            return
        self._call_hooks("after_train")

    def train(self):
        with EventStorage() as self.storage, ExceptionWriter():
            self.before_train()
            self.logger.info(">>>>>>>>>>>>>>>> Start Training >>>>>>>>>>>>>>>>")
            for self.epoch in range(self.start_epoch, self.max_epoch):
                self.before_epoch()
                self.train_loader.set_epoch(self.epoch)
                for i, input_dict in enumerate(self.iter_loader()):
                    self.comm_info["iter"] = i
                    self.comm_info["input_dict"] = input_dict
                    self.before_step()
                    self.run_step()
                    self.after_step()
                self.after_epoch()
            self.after_train()

    def iter_loader(self):
        return iter(self.train_loader)


@TRAINERS.register_module("DefaultTrainer")
class Trainer(TrainerBase):
    """The config-driven trainer on one device (the GPU unless `device`
    names another; raises when no GPU is present and none is named). A
    config whose pipelines add a condition its model does not know
    (`check_conditions`) is refused before anything is built."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        check_conditions(cfg)
        for key, off in (("enable_wandb", False), ("grad_accum_steps", 1)):
            if cfg.get(key, off) not in (off, None):
                raise NotImplementedError(f"Trainer: {key}={cfg.get(key)!r} is not ported")
        self.max_epoch = cfg.eval_epoch
        self.best_metric_value = -float("inf")
        self.logger = get_root_logger(log_file=os.path.join(cfg.save_path, "train.log"),
                                      file_mode="a" if cfg.get("resume") else "w")
        self.logger.info(f"Save path: {cfg.save_path}")
        self.logger.info("=> Building model ...")
        self.model = self.build_model()
        self.logger.info(f"Num params: {sum(p.numel() for p in self.model.parameters())}")
        self.logger.info("=> Building train dataset & dataloader ...")
        self.train_loader = self.build_train_loader()
        self.logger.info("=> Building val dataset & dataloader ...")
        self.val_loader = self.build_val_loader()
        self.logger.info("=> Building optimizer, scheduler ...")
        self.optimizer = build_optimizer(dict(cfg.optimizer), self.model, cfg.get("param_dicts"))
        self.scheduler = self.build_scheduler()
        self.train_step = build_train_step(self.model, self.optimizer, self.scheduler, cfg.get("clip_grad"))
        self.generator = torch.Generator(device=self.device)
        self.logger.info("=> Building hooks ...")
        self.register_hooks(cfg.hooks)

    # ------------------------------------------------------------------ builders
    def build_model(self):
        """The model on the device, its weights drawn from the shared seed."""
        cfg = apply_amp_policy(dict(self.cfg.model), self.cfg.get("enable_amp", False))
        seed = int(self.cfg.get("shared_seed", self.cfg.seed))
        return build_model(cfg, device=self.device, generator=torch.Generator().manual_seed(seed))

    def _loader(self, data_cfg, capacity: int, batch_size: int, train: bool) -> DataLoader:
        return DataLoader(
            build_dataset(dict(data_cfg)), batch_size=batch_size, shuffle=train,
            num_workers=self.cfg.get("num_worker", 0),
            collate_fn=partial(point_collate_fn, capacity=capacity,
                               mix_prob=self.cfg.get("mix_prob", 0.0) if train else 0.0, drop_overflow=train),
            drop_last=train, seed=int(self.cfg.get("shared_seed", self.cfg.seed)),
            pin_memory=self.device.type == "cuda")

    @property
    def capacity(self) -> int:
        return int(self.cfg.get("point_capacity", 131072))

    def build_train_loader(self):
        return self._loader(self.cfg.data.train, self.capacity, self.cfg.batch_size, train=True)

    def build_val_loader(self):
        if not self.cfg.get("evaluate", True) or "val" not in self.cfg.data:
            return None
        capacity = int(self.cfg.get("point_capacity_val") or self.capacity)
        return self._loader(self.cfg.data.val, capacity, self.cfg.get("batch_size_val") or 1, train=False)

    def build_scheduler(self):
        total_steps = len(self.train_loader) * self.max_epoch
        self.logger.info(f"Scheduler total steps: {total_steps}")
        cfg = dict(self.cfg.scheduler)
        if "max_lr" not in cfg and cfg.get("type") == "OneCycleLR":
            cfg["max_lr"] = self.cfg.optimizer.lr
        if cfg.get("type") != "OneCycleLR":
            cfg["base_lr"] = self.cfg.optimizer.lr
        return build_scheduler(cfg, self.optimizer, total_steps)

    # ---------------------------------------------------------------- train step
    def run_step(self):
        """One step of the batch in ``comm_info["input_dict"]`` (with the
        hyperparameters a hook put in ``comm_info["model_hyper"]``). The
        losses and the two overflow counters come to the host in one read;
        an overflow, or points the collate subsampled away
        (``collate_dropped``), is logged as a warning, as the JAX trainer
        does for overflows."""
        batch = self.comm_info["input_dict"]
        inputs = make_inputs(batch, device=self.device)
        global_step = self.epoch * len(self.train_loader) + self.comm_info["iter"]
        self.generator.manual_seed(step_seed(self.cfg.get("shared_seed", self.cfg.seed), global_step))
        lr = self.optimizer.param_groups[0]["lr"]
        res = self.train_step(inputs, self.generator, self.comm_info.get("model_hyper"))
        names = list(res)
        values = dict(zip(names, torch.stack([res[k].float() for k in names]).tolist()))
        loss, pool, block = values["loss"], values["pool_overflow"], values["block_overflow"]
        if self.cfg.get("empty_cache") and self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.comm_info["metrics"] = {k: v for k, v in values.items() if k.endswith("loss")}
        self.comm_info["lr"] = lr
        for name in self.comm_info["metrics"]:
            self.storage.put_scalar(name, values[name])
        self.storage.put_scalar("lr", lr, smoothing_hint=False)
        dropped = batch.get("dropped")
        if dropped is not None:
            self.storage.put_scalar("collate_dropped", int(dropped), smoothing_hint=False)
            if int(dropped) > 0:
                self.logger.warning(f"collate_dropped={int(dropped)} points subsampled away this step "
                                    "— increase point_capacity")
        for name, value in (("pool_overflow", pool), ("block_overflow", block)):
            self.storage.put_scalar(name, value, smoothing_hint=False)
            if value > 0:
                self.logger.warning(f"{name}={int(value)} points dropped by static capacity this step "
                                    "— increase pool_capacity_factors/block_capacity_factor")
        if not math.isfinite(loss):
            self.logger.warning(f"non-finite loss {loss} at step {global_step}")

    # ---------------------------------------------------------------- eval step
    @torch.no_grad()
    def eval_step(self, batch) -> dict:
        """The eval forward of one val batch: per-class intersection, union
        and target over the valid points (label not ignored), or over the
        valid clouds of a classifier (``category`` not -1), the loss and the
        overflow counters, read to the host at once."""
        num_classes = self.cfg.data.num_classes
        ignore_index = self.cfg.data.get("ignore_index", -1)
        pb = make_point_batch(batch, batch["num_scenes"], device=self.device)
        self.model.eval()
        res = self.model(pb)
        if "cls_logits" in res:
            pred, label = res["cls_logits"].argmax(dim=-1), pb.category.long()
            valid = label >= 0
        else:
            pred, label = res["seg_logits"].argmax(dim=-1), pb.segment.long()
            valid = (label != ignore_index) & pb.mask
        pred = torch.where(valid, pred, num_classes)
        label = torch.where(valid, label, num_classes)
        inter = torch.bincount(torch.where(pred == label, pred, num_classes), minlength=num_classes + 1)
        target = torch.bincount(label, minlength=num_classes + 1)
        output = torch.bincount(pred, minlength=num_classes + 1)
        union = output + target - inter
        loss = res.get("loss", torch.zeros((), device=self.device))
        diag = res["diagnostics"]
        host = torch.cat([inter[:num_classes].double(), union[:num_classes].double(),
                          target[:num_classes].double(), loss.double().view(1),
                          _total(diag["pool_overflow"], self.device).double().view(1),
                          _total(diag["block_overflow"], self.device).double().view(1)]).cpu().numpy()
        c = num_classes
        out = dict(intersection=host[:c], union=host[c : 2 * c], target=host[2 * c : 3 * c],
                   loss=float(host[3 * c]), pool_overflow=int(host[3 * c + 1]),
                   block_overflow=int(host[3 * c + 2]))
        for name in ("pool_overflow", "block_overflow"):
            if out[name] > 0:
                self.logger.warning(f"{name}={out[name]} points dropped by static capacity in eval")
        return out


def _pipeline_conditions(data_cfg) -> list:
    """The conditions a dataset config's pipeline adds (``Add`` / ``Update``
    of ``condition``), over the datasets of a `ConcatDataset`."""
    data_cfg = dict(data_cfg)
    if data_cfg.get("type") == "ConcatDataset":
        return [c for d in data_cfg["datasets"] for c in _pipeline_conditions(d)]
    test_cfg = dict(data_cfg.get("test_cfg") or {})
    steps = [dict(t) for t in list(data_cfg.get("transform") or []) + list(test_cfg.get("post_transform") or [])]
    return [t["keys_dict"]["condition"] for t in steps
            if t.get("type") in ("Add", "Update") and "condition" in (t.get("keys_dict") or {})]


def _pdnorm_backbone(backbone: dict) -> tuple:
    """(whether a backbone config normalises with PDNorm, whether
    adaptively): SpUNet-v1m3, or ``conditions`` / ``pdnorm_bn`` /
    ``pdnorm_ln`` set."""
    pd = (backbone.get("type") == "SpUNet-v1m3" or backbone.get("conditions") is not None
          or bool(backbone.get("pdnorm_bn")) or bool(backbone.get("pdnorm_ln")))
    adaptive = backbone.get("norm_adaptive")
    return pd, pd and bool(backbone.get("pdnorm_adaptive", False) if adaptive is None else adaptive)


def check_conditions(cfg) -> None:
    """Refuse a config whose data pipelines add a condition that its model
    (a PPT wrapper's ``conditions``) does not know, naming both lists: the
    outdoor PPT configs inherit the indoor data of their ``_base_`` and keep
    its ScanNet / Structured3D conditions under SemanticKITTI / nuScenes /
    Waymo models. Without a PPT wrapper, refuse a PDNorm backbone that no
    batch could drive: one whose pipelines add no condition (each norm
    picks the batch's), or an adaptive one (its modulation reads the
    context only a wrapper's table gives) — the PointGroup PPT fine-tunes
    (`insseg-ppt-v1m1-0-pointgroup-spunet-ft*.py`), which would raise at
    the first forward."""
    model = dict(cfg.model)
    known = model.get("conditions")
    added = [c for part in ("train", "val", "test") if part in cfg.data for c in _pipeline_conditions(cfg.data[part])]
    if known is None:
        pd, adaptive = _pdnorm_backbone(dict(model.get("backbone") or {}))
        if pd and not added:
            raise ValueError(f"the backbone {dict(model['backbone'])['type']} normalises with PDNorm, which needs "
                             "each batch's condition, and the data pipelines add none (no `Add` of `condition`)")
        if adaptive:
            raise ValueError(f"the backbone's PDNorm is adaptive (norm_adaptive), which needs a context embedding; "
                             f"only a Point Prompt Training wrapper gives one, and the model is {model.get('type')}")
        return
    unknown = sorted({c for c in added if c not in tuple(known)})
    if unknown:
        raise ValueError(f"the data pipelines add the conditions {sorted(set(added))}, the model knows "
                         f"{tuple(known)}: {unknown} would raise at the first forward")


@TRAINERS.register_module("MultiDatasetTrainer")
class MultiDatasetTrainer(Trainer):
    """Point Prompt Training's trainer (reference `engines/train.py`,
    `MultiDatasetTrainer`): train batches from `MultiDatasetDataloader`,
    one dataset (condition) a batch, the sub-datasets interleaved by their
    `loop` ratios; everything else the `Trainer`'s."""

    def build_train_loader(self):
        return MultiDatasetDataloader(
            build_dataset(dict(self.cfg.data.train)), batch_size_per_gpu=self.cfg.batch_size,
            num_worker_per_gpu=self.cfg.get("num_worker", 0),
            collate_fn=partial(point_collate_fn, capacity=self.capacity, mix_prob=self.cfg.get("mix_prob", 0.0)),
            seed=int(self.cfg.get("shared_seed", self.cfg.seed)), pin_memory=self.device.type == "cuda")


def main_worker(cfg, device=None):
    """What `tools/torch_port_train.py` runs on a parsed config: the
    per-process setup, the trainer the config names, training. Returns the
    trainer."""
    from .defaults import default_setup

    cfg = default_setup(cfg)
    trainer = TRAINERS.build(dict(type=cfg.train.type, cfg=cfg, device=device))
    trainer.train()
    return trainer
