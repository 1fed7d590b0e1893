"""The precise-eval tester (counterparts of `TESTERS`, `TesterBase`,
`SemSegTester`, `InsSegTester`, `ClsTester`, `ClsVotingTester`,
`ShapeNetPartSegTester` and `PartNetEPartSegTester` in
`pointcept_tpu/engines/test.py`;
parity target: reference `pointcept/engines/test.py:37-353`, `:1159`).
`InsSegTester` (PointGroup) runs one forward a scene and clusters on the
host; the rest of this text is `SemSegTester`'s.

A test scene is a list of fragments (`DefaultDataset` in test mode): every
view of `aug_transform`, cut by GridSample's test mode into fragments that
each hold one point of every voxel of the view (one voxel grid a view).
Each fragment's softmax is added into the rows of its points; the argmax,
mapped back through ``inverse`` where the pipeline keeps full-resolution
labels, is the prediction.

On the device: scenes come through a `torch.utils.data.DataLoader` (batch
1, ``num_worker`` workers) whose collate (`SceneLoader`) also groups a
scene's fragments by their voxel grid and packs them, so the next scene is
built while the card runs this one. The fragments of one grid share their forward geometry
(`PT-v3m1.build_geometry`): it is built once a group on B tiled copies of
the grid (B = ``tester_fragment_batch``), then ceil(n / B) forwards of B
fragments run through it. Each fragment's f32 softmax is added into a
device-resident ``[n_vox + capacity, C]`` accumulator with `index_add_`;
pad rows go to distinct trash rows, so no two adds of one call meet one
row and the sums are the same bits run to run. The prediction comes to the
host once a scene. Other backbones (an ``enc_mode`` PT-v3 among them: its
skip chain has no shared geometry), or ``fragment_geometry_reuse=False``,
run one forward a fragment. A backbone with RoPE reads each fragment's own
coordinates, so its groups bring them beside the features. Every forward
carries the fragments' ``condition`` (the PPT configs' ``Add`` in
`post_transform`), grouped or not: a Point Prompt Training wrapper over a
PT-v3 decoder takes the grouped path too. (The JAX tester's forwards carry
none, so a PPT model fails there on the first fragment.)

The classification testers (`ClsTester`, `ClsVotingTester`) run one
forward a cloud; the part-seg testers (`ShapeNetPartSegTester`,
`PartNetEPartSegTester`) take `SemSegTester`'s voted predictions and score
each shape's parts.

Not ported: the JAX tester's wire, host geometry and dispatch/collect split
(TPU workarounds), the host accumulation loop (``device_accumulate=False``
raises), the other testers, multi-process gathering.
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..datasets import build_dataset
from ..datasets.utils import collate_fn, pad_to_point_batch
from ..models import apply_amp_policy, build_model
from ..models.utils.structure import PointBatch, grid_bits
from ..utils.device import resolve_device
from ..utils.logger import get_root_logger
from ..utils.misc import AverageMeter, intersection_and_union, make_dirs
from ..utils.registry import Registry
from .hooks.misc import remap_state_dict
from .train import check_conditions, make_point_batch

TESTERS = Registry("testers")


class _Timer:
    """Device-side intervals: CUDA events on a card (read once the scene has
    synchronised), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans = {}

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def add(self, name: str, start, end):
        self.spans.setdefault(name, []).append((start, end))

    def ms(self) -> dict:
        """Each span's intervals in ms (call after a synchronisation)."""
        return {name: [s.elapsed_time(e) if self.cuda else (e - s) * 1e3 for s, e in spans]
                for name, spans in self.spans.items()}


class SceneLoader:
    """The collate of the tester's loader: ``dataset[idx]`` of the batch's
    one index, then its fragments packed for the card (in the loader's
    workers; it holds no model, so it pickles small). With `grouped`, the
    fragments are keyed by their voxel grid (its bytes and length); each
    group brings its grid once, its fragments' features ``[k, n, F]``,
    source indices ``[k, n]`` and condition, and with `with_coord` its
    fragments' coords ``[k, n, 3]`` (PT-v3's logits read the grid, and
    coords only through RoPE). Otherwise each fragment comes padded to `capacity`. A scene whose
    pred is cached in `result_dir` is not packed."""

    def __init__(self, dataset, capacity: int, grouped: bool, result_dir: str, with_coord: bool = False):
        self.dataset = dataset
        self.capacity = capacity
        self.grouped = grouped
        self.result_dir = result_dir
        self.with_coord = with_coord

    def __call__(self, batch) -> dict:
        (idx,) = batch
        t0 = time.perf_counter()
        data = self.dataset[idx]
        t1 = time.perf_counter()
        fragments = data.pop("fragment_list")
        data["num_fragments"] = len(fragments)
        data["num_points"] = sum(f["coord"].shape[0] for f in fragments)
        data["groups"] = data["fragments"] = None
        if not os.path.isfile(os.path.join(self.result_dir, f"{data['name']}_pred.npy")):
            if self.grouped and all("grid_coord" in f for f in fragments):
                data["groups"] = self._group(fragments)
            else:
                data["fragments"] = [self._pad(f) for f in fragments]
        data["host_ms"] = dict(dataset=(t1 - t0) * 1e3, pack=(time.perf_counter() - t1) * 1e3)
        return data

    def _check_size(self, n: int):
        if n > self.capacity:
            raise ValueError(f"fragment has {n} points > point_capacity_test {self.capacity}")

    def _group(self, fragments) -> list:
        groups = OrderedDict()
        for f in fragments:
            n = f["coord"].shape[0]
            self._check_size(n)
            grid = np.ascontiguousarray(f["grid_coord"], np.int32)
            key = (hashlib.blake2b(grid.tobytes(), digest_size=16).hexdigest(), n, f.get("condition"))
            g = groups.setdefault(key, dict(grid=grid, feat=[], index=[], coord=[], condition=f.get("condition")))
            g["feat"].append(np.asarray(f["feat"], np.float32))
            g["index"].append(np.asarray(f["index"]).astype(np.int32))
            if self.with_coord:
                g["coord"].append(np.asarray(f["coord"], np.float32))
        return [dict(grid=torch.from_numpy(g["grid"]), feat=torch.from_numpy(np.stack(g["feat"])),
                     index=torch.from_numpy(np.stack(g["index"])),
                     coord=torch.from_numpy(np.stack(g["coord"])) if self.with_coord else None,
                     condition=g["condition"])
                for g in groups.values()]

    def _pad(self, fragment) -> dict:
        index = np.asarray(fragment.pop("index")).astype(np.int32)
        self._check_size(fragment["coord"].shape[0])
        arrays = pad_to_point_batch(collate_fn([fragment]), self.capacity, num_scenes=1)
        arrays.pop("num_scenes")
        arrays = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in arrays.items()}
        arrays["index"] = torch.from_numpy(index)
        return arrays


class TesterBase:
    """The model (from ``cfg.model`` through the AMP policy, weights from
    ``cfg.weight``), the test dataset and its loader, on `device` (the GPU
    unless the caller names another; raises when no GPU is present and none
    is named)."""

    def __init__(self, cfg, model=None, device=None, verbose: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.verbose = verbose
        check_conditions(cfg)
        make_dirs(cfg.save_path)
        self.logger = get_root_logger(log_file=os.path.join(cfg.save_path, "test.log"), file_mode="a")
        self.logger.info("=> Building model ...")
        self.model = model if model is not None else self.build_model()
        self.logger.info("=> Building test dataset & loader ...")
        # `submit` asks the tester for the benchmark's files; no dataset takes it
        # (the JAX tester passes it on, and its dataset refuses the keyword)
        self.test_dataset = build_dataset({k: v for k, v in self.test_data_config().items() if k != "submit"})
        self._fragment_batch()  # refuse a batch below 1 before any scene is built

    def test_data_config(self) -> dict:
        """The config of the test dataset: ``data.test``."""
        return dict(self.cfg.data.test)

    def build_model(self):
        cfg = apply_amp_policy(dict(self.cfg.model), self.cfg.get("enable_amp", False))
        seed = int(self.cfg.get("shared_seed", self.cfg.get("seed", 0)) or 0)
        model = build_model(cfg, device=self.device, generator=torch.Generator().manual_seed(seed))
        weight = self.cfg.get("weight")
        if weight and os.path.isfile(weight):
            self.logger.info(f"Loading weight at: {weight}")
            # the trainer's checkpoints: tensors, numbers and state dicts
            checkpoint = torch.load(weight, map_location=self.device, weights_only=False)
            model.load_state_dict(remap_state_dict(checkpoint.get("state_dict", checkpoint)), strict=True)
        else:
            self.logger.info(f"No weight found at: {weight}")
        return model.eval()

    @property
    def test_capacity(self) -> int:
        return int(self.cfg.get("point_capacity_test", self.cfg.get("point_capacity", 131072)))

    def _fragment_batch(self) -> int:
        """Fragments per forward in the grouped path (``tester_fragment_batch``)."""
        b = int(self.cfg.get("tester_fragment_batch", 4))
        if b < 1:
            raise ValueError(f"tester_fragment_batch must be at least 1, got {b}")
        return b

    def _slot_bucket(self, n: int) -> int:
        """Slots of a group of n fragments: n at 1 or 2, else n rounded up to
        whole forwards (at most B - 1 dummy slots)."""
        b = self._fragment_batch()
        if n <= 2:
            return n
        return ((n + b - 1) // b) * b

    def _fragment_geometry_ok(self) -> bool:
        """The grouped path: a PT-v3 backbone with its decoder under
        `DefaultSegmentorV2` or a Point Prompt Training wrapper, unless
        ``fragment_geometry_reuse`` is off. An ``enc_mode`` backbone (the
        linear probes and fine-tunes) takes the per-fragment path: `build_geometry` serves the decoder path only (the
        JAX tester sends it to the grouped path, where it fails)."""
        if not self.cfg.get("fragment_geometry_reuse", True):
            return False
        model_cfg = dict(self.cfg.model)
        if model_cfg.get("type") not in ("DefaultSegmentorV2", "PPT-v1m1", "PPT-v1m2", "PPT-v1m3"):
            return False
        bb = dict(model_cfg.get("backbone") or {})
        return str(bb.get("type", "")).startswith("PT-v3") and not bb.get("enc_mode", False)

    def _fragment_coord(self) -> bool:
        """Whether the backbone reads the fragments' own coordinates (RoPE:
        PT-v3m3 unless its ``rope_base`` is None), as the JAX tester's
        `_coord_from_grid_ok` decides."""
        bb = dict(dict(self.cfg.model).get("backbone") or {})
        return bb.get("type") == "PT-v3m3" and bb.get("rope_base", 10000.0) is not None

    def check_dropped(self, dropped: int, n_valid: int, context: str):
        """Raise when the static capacities dropped more than
        ``eval_overflow_tolerance`` (default 0.1%) of the points; log any
        drop below it."""
        if dropped <= 0:
            return
        frac = dropped / max(n_valid, 1)
        tol = float(self.cfg.get("eval_overflow_tolerance", 1e-3))
        if frac > tol:
            raise RuntimeError(
                f"{context}: static capacity dropped {dropped}/{n_valid} points ({frac:.2%} > {tol:.2%}); "
                "raise pool_capacity_factors / block_capacity_factor (or eval_overflow_tolerance to accept)"
            )
        self.logger.warning(f"{context}: static capacity dropped {dropped}/{n_valid} points ({frac:.3%})")

    def test(self):
        raise NotImplementedError


@TESTERS.register_module()
class SemSegTester(TesterBase):
    def __init__(self, cfg, model=None, device=None, verbose: bool = False):
        if not cfg.get("device_accumulate", True):
            raise NotImplementedError("SemSegTester: device_accumulate=False (the host accumulation loop) "
                                      "is not ported")
        if cfg.get("batch_size_test_per_gpu", 1) != 1:
            raise ValueError("SemSegTester: one scene a batch")
        super().__init__(cfg, model=model, device=device, verbose=verbose)
        self.result_dir = os.path.join(cfg.save_path, "result")
        self.scene_stats = []

    def _pred_path(self, name: str) -> str:
        return os.path.join(self.result_dir, f"{name}_pred.npy")

    def build_test_loader(self):
        """One scene a batch, built and packed by `SceneLoader` in
        ``num_worker`` spawned workers (at most one a scene)."""
        workers = min(int(self.cfg.get("num_worker_per_gpu", self.cfg.get("num_worker", 0)) or 0),
                      len(self.test_dataset))
        scenes = SceneLoader(self.test_dataset, self.test_capacity, self._fragment_geometry_ok(), self.result_dir,
                             with_coord=self._fragment_coord())
        return torch.utils.data.DataLoader(
            range(len(self.test_dataset)), batch_size=1, shuffle=False, num_workers=workers,
            collate_fn=scenes, pin_memory=self.device.type == "cuda",
            multiprocessing_context="spawn" if workers else None,
            # a scene's fragments take GBs: one scene ahead a worker
            prefetch_factor=1 if workers else None)

    # ----------------------------------------------------------- device side
    def _accumulate_groups(self, groups, pred, n_vox: int, timer: _Timer, stats: dict):
        """Each group: its geometry once, then its fragments B at a time;
        returns the summed overflow (a device scalar)."""
        cap, dev, model = self.test_capacity, self.device, self.model
        grid_size = float(dict(dict(self.cfg.model)["backbone"]).get("grid_size", 0.02))
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        trash = n_vox + torch.arange(cap, device=dev)
        for gi, g in enumerate(groups):
            k, n = g["index"].shape
            slots = self._slot_bucket(k)
            b = min(self._fragment_batch(), slots)
            grid, feat = g["grid"].to(dev, non_blocking=True), g["feat"].to(dev, non_blocking=True)
            index = g["index"].to(dev, non_blocking=True).long()
            rows = [trash] * slots  # dummy slots: every row to the trash
            for j in range(k):
                rows[j] = torch.cat([index[j], trash[n:]])
            grid_b = torch.zeros((b * cap, 3), dtype=torch.int32, device=dev)
            batch_b = torch.full((b * cap,), -1, dtype=torch.int32, device=dev)
            for s in range(b):
                grid_b[s * cap : s * cap + n] = grid
                batch_b[s * cap : s * cap + n] = s
            template = PointBatch(coord=grid_b.float() * grid_size, feat=None, grid_coord=grid_b,
                                  batch=batch_b, num_scenes=b, grid_depth=grid_bits(g["grid"]),
                                  condition=g.get("condition"))
            t0 = timer.mark()
            with torch.no_grad():
                geom = model.backbone.build_geometry(template)
            timer.add("geometry", t0, timer.mark())
            feat_b = torch.zeros((b * cap, feat.shape[2]), dtype=torch.float32, device=dev)
            coord = None if g.get("coord") is None else g["coord"].to(dev, non_blocking=True)
            coord_b = template.coord if coord is None else torch.zeros_like(template.coord)
            for j0 in range(0, slots, b):
                for s in range(b):
                    # a dummy slot runs fragment 0 again, its rows to the trash
                    src = j0 + s if j0 + s < k else 0
                    feat_b[s * cap : s * cap + n] = feat[src]
                    if coord is not None:
                        coord_b[s * cap : s * cap + n] = coord[src]
                t0 = timer.mark()
                res = model(template.replace(feat=feat_b, coord=coord_b), precomputed=geom)
                probs = torch.softmax(res["seg_logits"].float(), dim=-1)
                for s in range(b):
                    pred.index_add_(0, rows[j0 + s], probs[s * cap : (s + 1) * cap])
                timer.add("forward", t0, timer.mark())
                dropped += sum(v for vs in res["diagnostics"].values() for v in vs)
            stats["forwards"] += slots // b
            stats["batch"] = max(stats.get("batch", 0), b)
            if self.verbose:
                self.logger.info(f"Fragment group {gi + 1}/{len(groups)}: {k} fragments, {slots // b} forwards")
        return dropped

    def _accumulate_fragments(self, fragments, pred, n_vox: int, timer: _Timer, stats: dict):
        """One forward a fragment (no shared geometry)."""
        cap, dev = self.test_capacity, self.device
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        trash = n_vox + torch.arange(cap, device=dev)
        for f in fragments:
            index = f.pop("index").to(dev, non_blocking=True).long()
            t0 = timer.mark()
            res = self.model(make_point_batch(f, 1, device=dev))
            probs = torch.softmax(res["seg_logits"].float(), dim=-1)
            pred.index_add_(0, torch.cat([index, trash[index.shape[0]:]]), probs)
            timer.add("forward", t0, timer.mark())
            dropped += sum(v for vs in res["diagnostics"].values() for v in vs)
            stats["forwards"] += 1
        stats["batch"] = 1
        return dropped

    def infer_scene(self, scene: dict, num_classes: int) -> np.ndarray:
        """The scene's summed softmax at voxel resolution, [n_vox, C] f32."""
        n_vox = scene["segment"].shape[0]
        pred = torch.zeros((n_vox + self.test_capacity, num_classes), dtype=torch.float32, device=self.device)
        timer = _Timer(self.device)
        stats = dict(name=scene["name"], fragments=scene["num_fragments"], points=scene["num_points"], forwards=0,
                     groups=len(scene["groups"]) if scene["groups"] is not None else None)
        if scene["groups"] is not None:
            dropped = self._accumulate_groups(scene["groups"], pred, n_vox, timer, stats)
        else:
            dropped = self._accumulate_fragments(scene["fragments"], pred, n_vox, timer, stats)
        out = pred[:n_vox].cpu().numpy()
        stats["dropped"] = int(dropped)
        stats.update({f"{k}_ms": v for k, v in timer.ms().items()})
        self.scene_stats.append(stats)
        self.check_dropped(stats["dropped"], max(scene["num_points"], 1), scene["name"])
        return out

    # ------------------------------------------------------------------ test
    def scene_preds(self):
        """Each test scene's ``(pos, scene, pred, segment)``: its summed
        softmax (loaded where cached, else inferred and saved; mapped back
        through ``inverse`` where the pipeline keeps full-resolution labels)
        and its labels. A scene's ``scene_ms`` ends when the caller asks for
        the next one."""
        self.model.eval()
        make_dirs(self.result_dir)
        num_classes = self.cfg.data.num_classes
        self.scene_stats = []
        start = time.perf_counter()
        for pos, scene in enumerate(self.build_test_loader()):
            # the scene's own start: its wait for the loader, then its work
            loaded = time.perf_counter()
            name, segment = scene["name"], scene["segment"]
            cached = scene["groups"] is None and scene["fragments"] is None
            if cached:
                self.logger.info(f"{pos + 1}/{len(self.test_dataset)}: {name}, loaded pred and label.")
                pred = np.load(self._pred_path(name))
                segment = scene.get("origin_segment", segment)
            else:
                pred = self.infer_scene(scene, num_classes)
                self.scene_stats[-1].update(loader_wait_ms=(loaded - start) * 1e3, host_ms=scene["host_ms"])
                if "origin_segment" in scene:
                    pred = pred[scene["inverse"]]
                    segment = scene["origin_segment"]
                np.save(self._pred_path(name), pred)
            yield pos, scene, pred, segment
            end = time.perf_counter()
            if not cached:
                self.scene_stats[-1]["scene_ms"] = (end - start) * 1e3
            start = end

    def test(self):
        logger = self.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        batch_time = AverageMeter()
        num_classes = self.cfg.data.num_classes
        ignore_index = self.cfg.data.get("ignore_index", -1)
        submit_dir = None
        if self.cfg.data.test.get("submit", False):
            submit_dir = os.path.join(self.result_dir, "submit")
            make_dirs(submit_dir)
            if self.cfg.data.test.type in NUSCENES_TYPES:
                write_nuscenes_meta(submit_dir)
        record = {}
        n_scenes = len(self.test_dataset)
        start = time.perf_counter()
        for pos, scene, pred, segment in self.scene_preds():
            name = scene["name"]
            pred_label = np.argmax(pred, axis=-1)
            if submit_dir is not None:
                self.write_submission(submit_dir, name, pred_label)
            intersection, union, target = intersection_and_union(pred_label, segment, num_classes, ignore_index)
            record[name] = dict(intersection=intersection, union=union, target=target)
            mask = union != 0
            iou = np.mean((intersection / (union + 1e-10))[mask])
            acc = sum(intersection) / (sum(target) + 1e-10)
            end = time.perf_counter()
            batch_time.update(end - start)
            logger.info(f"Test: {name} [{pos + 1}/{n_scenes}]-{segment.size} "
                        f"Batch {batch_time.val:.3f} ({batch_time.avg:.3f}) Accuracy {acc:.4f} mIoU {iou:.4f}")
            start = end

        intersection = np.sum([m["intersection"] for m in record.values()], axis=0)
        union = np.sum([m["union"] for m in record.values()], axis=0)
        target = np.sum([m["target"] for m in record.values()], axis=0)
        # the record of a fold, for cross-fold evaluation
        np.savez(os.path.join(self.result_dir, "record.npz"), intersection=intersection, union=union,
                 target=target)
        iou_class = intersection / (union + 1e-10)
        accuracy_class = intersection / (target + 1e-10)
        m_iou, m_acc = np.mean(iou_class), np.mean(accuracy_class)
        all_acc = sum(intersection) / (sum(target) + 1e-10)
        logger.info(f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}")
        names = self.cfg.data.get("names", [str(i) for i in range(num_classes)])
        for i in range(num_classes):
            logger.info(f"Class_{i} - {names[i]} Result: iou/accuracy {iou_class[i]:.4f}/{accuracy_class[i]:.4f}")
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        return dict(mIoU=float(m_iou), mAcc=float(m_acc), allAcc=float(all_acc))

    def write_submission(self, submit_dir: str, name: str, pred_label: np.ndarray):
        """The benchmark's submission file: ScanNet's label ids as text;
        SemanticKITTI's ``sequences/<seq>/predictions/<frame>.label`` (raw
        ids through `learning_map_inv`, uint32); nuScenes' lidarseg
        ``lidarseg/test/<lidar token>_lidarseg.bin`` (the challenge's class
        ids 1-16, uint8; `write_nuscenes_meta` writes its
        ``test/submission.json``); or the labels as .npy for the other
        ported datasets (ScanNet++ and S3DIS among them, as the JAX writer).
        ScanNet200's needs the benchmark's 200 label ids, which the
        repository does not hold: it raises, where the JAX writer maps the
        200-way preds through ScanNet's 20 ids and fails on the first pred
        above 19. The JAX writer's nuScenes files are named by the lidar
        file's stem and hold the 32-category ids, which the challenge's
        validator refuses."""
        ds_type = self.cfg.data.test.type
        if ds_type == "ScanNet200Dataset":
            raise NotImplementedError(
                "SemSegTester: the ScanNet200 submission needs the benchmark's 200 label ids (VALID_CLASS_IDS_200, "
                "from the ScanNet label mapping tsv that pointcept_tpu/datasets/preprocessing/scannet/"
                "preprocess_scannet.py:26-27 names); the repository does not hold that list")
        if ds_type == "ScanNetDataset":
            np.savetxt(os.path.join(submit_dir, f"{name}.txt"),
                       type(self.test_dataset).class2id[pred_label].reshape([-1, 1]), fmt="%d")
        elif ds_type in KITTI_TYPES:
            sequence_name, frame_name = name.split("_")
            pred_dir = os.path.join(submit_dir, "sequences", sequence_name, "predictions")
            make_dirs(pred_dir)
            inv = self.test_dataset.learning_map_inv
            lut = np.array([inv[i] for i in range(len(inv) - 1)], dtype=np.uint32)
            lut[pred_label].tofile(os.path.join(pred_dir, f"{frame_name}.label"))
        elif ds_type in NUSCENES_TYPES:
            lidarseg_dir = os.path.join(submit_dir, "lidarseg", "test")
            make_dirs(lidarseg_dir)
            token = self.test_dataset.lidar_token(name)
            (pred_label.astype(np.int64) + 1).astype(np.uint8).tofile(
                os.path.join(lidarseg_dir, f"{token}_lidarseg.bin"))
        else:
            np.save(os.path.join(submit_dir, f"{name}_pred.npy"), pred_label)


KITTI_TYPES = ("SemanticKITTIDataset", "SemanticKITTIColorNormalDataset")
NUSCENES_TYPES = ("NuScenesDataset", "NuScenesColorNormalDataset")


def write_nuscenes_meta(submit_dir: str):
    """The lidarseg challenge's ``test/submission.json``: the inputs the
    method used (lidar only)."""
    import json

    make_dirs(os.path.join(submit_dir, "test"))
    meta = dict(meta=dict(use_camera=False, use_lidar=True, use_radar=False, use_map=False, use_external=False))
    with open(os.path.join(submit_dir, "test", "submission.json"), "w") as f:
        json.dump(meta, f, indent=4)


@TESTERS.register_module()
class InsSegTester(TesterBase):
    """PointGroup's tester (counterpart of the JAX package's `InsSegTester`;
    reference `engines/test.py:1159`): one forward a scene on the device
    (padded to ``point_capacity_test``; a scene past it raises), its softmax
    and offsets read to the host, `propose_instances` there (the
    evaluator's `propose_batch`), and AP over the scenes
    (`utils.instance_eval`); with ``data.test.submit``, the
    benchmark's files (`write_submission`). ``scene_stats`` holds each
    scene's ms, forward ms, host clustering ms and proposals.

    The insseg configs say ``test=dict()`` and test on the val data: a
    ``data.test`` without a ``type`` takes ``data.val`` (the JAX tester
    builds the empty dict, and its dataset builder raises). A ``data.test``
    whose pipeline collects no features (the ScanNet++ ``-submit``
    configs' test split, which also lacks ``submit``) is refused, naming
    what is missing."""

    def __init__(self, cfg, model=None, device=None, verbose: bool = False, segment_ignore_index=(-1, 0, 1)):
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.scene_stats = []
        super().__init__(cfg, model=model, device=device, verbose=verbose)

    def test_data_config(self) -> dict:
        test = dict(self.cfg.data.test)
        if "type" not in test:
            return dict(self.cfg.data.val)
        collects = [dict(t) for t in test.get("transform") or [] if dict(t).get("type") == "Collect"]
        if not any(c.get("feat_keys") for c in collects):
            raise ValueError(
                f"InsSegTester: data.test ({test['type']}, split {test.get('split')!r}) has no `transform` whose "
                "`Collect` gathers `feat_keys`: its scenes would reach the model without features or offsets. "
                "Give data.test the val pipeline, and `submit=True` for the benchmark's files"
                + ("" if "submit" in test else " (it has no `submit` key)"))
        return test

    def test(self) -> dict:
        from ..utils.instance_eval import aggregate_ap
        from .hooks.evaluator import propose_batch, scene_records

        logger = self.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        self.model.eval()
        num_classes = self.cfg.data.num_classes - sum(1 for i in self.segment_ignore_index if i >= 0)
        records = {c: [] for c in range(num_classes)}
        gt_counts = {c: 0 for c in range(num_classes)}
        submit = bool(dict(self.cfg.data.test).get("submit", False))
        self.scene_stats = []
        for pos in range(len(self.test_dataset)):
            start = time.perf_counter()
            data = self.test_dataset[pos]
            fragment = data["fragment_list"][0] if "fragment_list" in data else data
            name = str(data.get("name", pos))
            n = fragment["coord"].shape[0]
            if n > self.test_capacity:
                raise ValueError(f"{name}: {n} points > point_capacity_test {self.test_capacity}")
            arrays = pad_to_point_batch(collate_fn([dict(fragment)]), self.test_capacity, num_scenes=1)
            loaded = time.perf_counter()
            out = propose_batch(self.model, arrays, self.device)
            (count,) = scene_records(*out["proposals"], out["host"], 1, num_classes, self.segment_ignore_index,
                                     records, gt_counts, pos)
            masks, classes, scores = out["proposals"]
            if submit:
                self.write_submission(name, masks[:, :n], classes, scores)
            stats = dict(name=name, points=n, proposals=count, dropped=out["dropped"], load_ms=(loaded - start) * 1e3,
                         forward_ms=out["forward_ms"], cluster_ms=out["cluster_ms"],
                         scene_ms=(time.perf_counter() - start) * 1e3)
            self.scene_stats.append(stats)
            self.check_dropped(out["dropped"], n, name)
            logger.info(f"Test: [{pos + 1}/{len(self.test_dataset)}] {name} proposals {count} "
                        f"forward {stats['forward_ms']:.1f} ms clustering {stats['cluster_ms']:.1f} ms")
        result = aggregate_ap(records, gt_counts, num_classes)
        logger.info("Val result: mAP/AP50/AP25 {:.4f}/{:.4f}/{:.4f}".format(result["mAP"], result["AP50"],
                                                                           result["AP25"]))
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        return result

    def write_submission(self, data_name: str, masks, classes, scores):
        """ScanNet's and ScanNet++'s instance benchmark format (the JAX
        package's, reference `test.py:1266-1303`), under
        ``save_path/result/submit``: ``<scene>.txt``, one line a proposal
        (``predicted_masks/<scene>_<i>.json <class> <score>``), and each
        mask as a run-length json (``length``, ``counts``: the 1-based
        starts and lengths of its runs)."""
        import json

        save_dir = os.path.join(self.cfg.save_path, "result", "submit")
        mask_dir = os.path.join(save_dir, "predicted_masks")
        make_dirs(mask_dir)
        lines = []
        for i, (mask, cls, score) in enumerate(zip(masks, classes, scores)):
            mask = np.asarray(mask).astype(np.uint8)
            padded = np.concatenate([[0], mask, [0]])
            runs = np.where(padded[1:] != padded[:-1])[0] + 1
            runs[1::2] -= runs[::2]
            rle = dict(length=int(mask.shape[0]), counts=" ".join(str(int(x)) for x in runs))
            with open(os.path.join(mask_dir, f"{data_name}_{i:03d}.json"), "w") as f:
                json.dump(rle, f, indent=2)
            lines.append(f"{os.path.join('predicted_masks', f'{data_name}_{i:03d}.json')} {int(cls)} {float(score):.4f}")
        with open(os.path.join(save_dir, f"{data_name}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))


@TESTERS.register_module()
class ClsTester(TesterBase):
    """Classification (counterpart of the JAX package's `ClsTester`;
    reference `engines/test.py:622`): one forward a cloud, padded to
    ``point_capacity_test``, its argmax against the cloud's ``category``;
    mIoU, mAcc and allAcc over the clouds. ``cloud_stats`` holds each
    cloud's ms, forward ms (the copy to the card and the read of the
    result included) and host ms (the dataset's pipeline and the padding).
    A cloud whose points the static capacities drop past
    ``eval_overflow_tolerance`` raises (`check_dropped`)."""

    def __init__(self, cfg, model=None, device=None, verbose: bool = False):
        self.cloud_stats = []
        super().__init__(cfg, model=model, device=device, verbose=verbose)

    def cloud_probs(self, idx: int) -> tuple:
        """(the cloud's category, its softmax [classes] in f32) from
        ``test_dataset[idx]``, which re-runs the pipeline; timed into
        ``cloud_stats``."""
        start = time.perf_counter()
        data = self.test_dataset[idx]
        category = int(np.asarray(data["category"]).reshape(-1)[0])
        n = data["coord"].shape[0]
        if n > self.test_capacity:
            raise ValueError(f"cloud {idx}: {n} points > point_capacity_test {self.test_capacity}")
        arrays = pad_to_point_batch(collate_fn([data]), self.test_capacity, num_scenes=1)
        loaded = time.perf_counter()
        with torch.no_grad():
            res = self.model(make_point_batch(arrays, 1, device=self.device))
            dropped = sum((v.float() for vs in res["diagnostics"].values() for v in vs), torch.zeros(()))
            host = torch.cat([torch.softmax(res["cls_logits"][0].float(), dim=-1),
                              dropped.to(res["cls_logits"].device).view(1)]).cpu().numpy()
        end = time.perf_counter()
        probs = host[:-1]
        self.check_dropped(int(host[-1]), n, f"cloud {idx}")
        self.cloud_stats.append(dict(points=n, host_ms=(loaded - start) * 1e3, forward_ms=(end - loaded) * 1e3,
                                     cloud_ms=(end - start) * 1e3))
        return category, probs

    def votes(self, idx: int) -> tuple:
        """(category, scores) of one cloud: its softmax."""
        return self.cloud_probs(idx)

    def test(self) -> dict:
        logger = self.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        self.model.eval()
        num_classes = self.cfg.data.num_classes
        inter, union, target = (np.zeros(num_classes) for _ in range(3))
        self.cloud_stats = []
        for pos in range(len(self.test_dataset)):
            category, scores = self.votes(pos)
            pred = int(scores.argmax())
            i, u, t = intersection_and_union(np.array([pred]), np.array([category]), num_classes)
            inter, union, target = inter + i, union + u, target + t
            logger.info(f"Test: [{pos + 1}/{len(self.test_dataset)}] pred {pred} gt {category}")
        m_iou = float(np.mean(inter / (union + 1e-10)))
        m_acc = float(np.mean(inter / (target + 1e-10)))
        all_acc = float(inter.sum() / (target.sum() + 1e-10))
        logger.info("Val result: mIoU/mAcc/allAcc {:.4f}/{:.4f}/{:.4f}".format(m_iou, m_acc, all_acc))
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        return dict(mIoU=m_iou, mAcc=m_acc, allAcc=all_acc)


@TESTERS.register_module()
class ClsVotingTester(ClsTester):
    """Test-time augmentation (counterpart of the JAX package's
    `ClsVotingTester`; reference `engines/test.py:724`): each cloud's
    softmax summed in f64 over `num_repeat` passes, each through the
    dataset's pipeline again (its random transforms drawn anew)."""

    def __init__(self, cfg, model=None, device=None, verbose: bool = False, num_repeat: int = 100,
                 metric: str = "allAcc"):
        self.num_repeat = int(num_repeat)
        self.metric = metric
        super().__init__(cfg, model=model, device=device, verbose=verbose)

    def votes(self, idx: int) -> tuple:
        record = np.zeros(self.cfg.data.num_classes, np.float64)
        category = None
        for _ in range(self.num_repeat):
            category, probs = self.cloud_probs(idx)
            record += probs
        return category, record


def part_ious(pred: np.ndarray, segment: np.ndarray, parts) -> list:
    """Each part's IoU in one shape: the argmax of `pred` [n, classes]
    over the shape's `parts` alone, against `segment`; 1.0 for a part
    neither holds."""
    masked = np.full_like(pred, -1e9)
    masked[:, parts] = pred[:, parts]
    label = masked.argmax(-1)
    ious = []
    for p in parts:
        u = ((label == p) | (segment == p)).sum()
        ious.append(((label == p) & (segment == p)).sum() / u if u > 0 else 1.0)
    return ious


@TESTERS.register_module()
class ShapeNetPartSegTester(SemSegTester):
    """ShapeNet-Part (counterpart of the JAX package's
    `ShapeNetPartSegTester`; reference `engines/test.py:841`): each shape's
    fragments voted into its points (`SemSegTester.scene_preds`), the
    argmax over its category's part range (`part_ious`), the mean part IoU
    a shape; ins.mIoU over the shapes and cat.mIoU over the categories that
    have shapes. The shape's ``category`` comes beside its fragments (the
    JAX tester reads ``coord`` and ``category`` from the test dataset's
    item, which in test mode holds fragments: it fails on the configs'
    test sections)."""

    def test(self) -> dict:
        from ..datasets.shapenet_part import ShapeNetPartDataset

        logger = self.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        categories = ShapeNetPartDataset.categories
        iou_per_cat = {c: [] for c in range(len(categories))}
        for pos, scene, pred, segment in self.scene_preds():
            cat = int(np.asarray(scene["category"]).reshape(-1)[0])
            iou = float(np.mean(part_ious(pred, segment, ShapeNetPartDataset.category2part[categories[cat]])))
            iou_per_cat[cat].append(iou)
            logger.info(f"Test: [{pos + 1}/{len(self.test_dataset)}] {scene['name']} cat {categories[cat]} "
                        f"iou {iou:.4f}")
        shapes = [v for lst in iou_per_cat.values() for v in lst]
        ins_iou = float(np.mean(shapes)) if shapes else 0.0
        cat_iou = float(np.mean([np.mean(lst) for lst in iou_per_cat.values() if lst])) if shapes else 0.0
        logger.info("Val result: ins.mIoU/cat.mIoU {:.4f}/{:.4f}".format(ins_iou, cat_iou))
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        return dict(ins_miou=ins_iou, cat_miou=cat_iou)


@TESTERS.register_module()
class PartNetEPartSegTester(SemSegTester):
    """PartNetE (counterpart of the JAX package's `PartNetEPartSegTester`;
    reference `engines/test.py:992-1158`): each sample's fragments voted
    into its points, then for each part of its category but "other" (the
    first) that the labels or the prediction hold, its IoU into that part's
    running mean; part.mIoU over the parts seen, cat.mIoU over the
    categories' means. The sample's ``cls_token`` comes beside its
    fragments (the JAX tester reads it from the first fragment, whose
    `Collect` has dropped it)."""

    def test(self) -> dict:
        logger = self.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        ds = self.test_dataset
        iou_sum = np.zeros(int(sum(ds.num_parts)), np.float64)
        iou_cnt = np.zeros_like(iou_sum)
        for pos, scene, pred, segment in self.scene_preds():
            category = ds.categories[int(np.asarray(scene["cls_token"]).reshape(-1)[0])]
            label = pred.argmax(-1)
            for part_id in ds.category2part[category][1:]:  # "other" excluded (reference :1072)
                gid = part_id + 1  # the labels lead with a shift of one
                if (segment == gid).sum() == 0 and (label == gid).sum() == 0:
                    continue
                inter = float(((segment == gid) & (label == gid)).sum())
                union = float(((segment == gid) | (label == gid)).sum())
                iou_sum[part_id] += inter / (union + 1e-10)
                iou_cnt[part_id] += 1
            logger.info(f"Test: [{pos + 1}/{len(ds)}] {scene['name']} ({category})")
        present = iou_cnt > 0
        part_iou = np.where(present, iou_sum / np.maximum(iou_cnt, 1), 0.0)
        miou = float(part_iou[present].mean()) if present.any() else 0.0
        cat_ious = []
        for cat in ds.categories:
            ids = [p for p in ds.category2part[cat][1:] if present[p]]
            if ids:
                cat_ious.append(float(np.mean([part_iou[p] for p in ids])))
        cat_miou = float(np.mean(cat_ious)) if cat_ious else 0.0
        logger.info("Val result: part.mIoU/cat.mIoU {:.4f}/{:.4f}".format(miou, cat_miou))
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        return dict(part_miou=miou, cat_miou=cat_miou)


def main_worker(cfg, device: Optional[str] = None):
    """What `tools/torch_port_test.py` runs on a parsed config: the
    per-process setup, the tester the config names, its test. Returns the
    tester and the result."""
    from .defaults import default_setup

    cfg = default_setup(cfg)
    tester = TESTERS.build(dict(cfg.test, cfg=cfg, device=device))
    return tester, tester.test()
