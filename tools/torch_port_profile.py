#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one CUDA card.

    python3 tools/torch_port_profile.py [--model ptv3|spunet|sonata|probe|utonia|lora|kitti|waymo] [--fused]
                                        [--requests N]
                                        [--train]
                                        [--out DIR]

Runs the PTv3-base eval forward of `chip_smoke.py` (102,400-point synthetic
scenes, one per request), or with `--train` its train step (two labelled
scenes per step, the config's recipe), under `torch.profiler`, after one
warm-up. `--model spunet`: SpUNet-v1m1 of `chip_smoke.py` instead (the fused
block conv); `--fused`: PTv3 with ``block_conv_fused=True`` (the fused
implicit-GEMM conv instead of cuDNN over halos; run with and without it in
turns for an A/B); `--model sonata`: the train step of
`configs/sonata/pretrain-sonata-v1m1-0-base.py` at `chip_smoke.py` phase
13's geometry (its train pipeline on two of phase 10's synthetic scenes a
step, 262,144 rows, the schedule's base hyperparameters); `--model probe`
and `--model utonia`: the train step of Sonata's linear probe
(`semseg-sonata-v1m1-0a-scannet-lin.py`, frozen encoder, random weights)
and of Utonia's fine-tune (`semseg-utonia-v1m1-0c-scannet-ft.py`, RoPE,
head dim 18, ``in_channels=6``) at phase 14's and 15's geometry (the same
scenes through the configs' train pipeline); `--model lora`: the train step
of Concerto-large's LoRA fine-tune
(`semseg-ptv3-large-v1m1-0f-scannet-ft-lora.py`, rank 16, the encoder
frozen, random weights, ``in_channels=6``) at phase 19's geometry; `--model kitti` and `--model waymo`: the
train step of the SemanticKITTI and Waymo PTv3 configs at phases 20 and 22's
geometry (two ray-cast scans a step through the config's train pipeline,
262,144 and 524,288 rows; KITTI at phase 20's pooling factors). It prints JSON lines: the calls that make the host wait for the
card in one request or step, the device's busy time per request or step and
its idle share of the same work run without the profiler, the device time
by category (the port's kernels, convs, matmuls, sorts, gathers and
scatters, elementwise) and the top kernels by device time. The full table,
and a second one of the ops by input shape, go to
DIR/torch_port_profile[_spunet][_fused][_train].txt (default build/profile/).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATEGORIES = [  # first match wins
    ("patch_attention kernel", r"patch_attention_fwd_kernel"),
    ("patch_attention_bwd kernels", r"attn_bwd_"),
    ("block_fill kernel", r"block_fill_kernel"),
    ("take_back kernel", r"take_back"),
    ("tap_conv kernels", r"tap_conv|occupied_list|partial_sum"),
    ("conv (cuDNN)", r"conv|cudnn|implicit|fprop|dgrad|nchw|nhwc|ndhwc"),
    ("matmul", r"gemm|cutlass|sm90_xmma|cublas|matmul"),
    ("sort", r"sort|radix|onesweep|histogram"),
    ("gather/scatter/index", r"index|gather|scatter|take|put"),
    ("reduce/scan", r"reduce|scan|cumsum|sum_kernel|max_kernel"),
    ("elementwise/copy", r"elementwise|vectorized|copy|fill|cat|unrolled|memcpy|memset"),
]


def category(name: str) -> str:
    for cat, pat in CATEGORIES:
        if re.search(pat, name, re.IGNORECASE):
            return cat
    return "other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4, help="requests or train steps profiled")
    ap.add_argument("--train", action="store_true", help="profile the train step")
    ap.add_argument("--model", choices=("ptv3", "spunet", "sonata", "probe", "utonia", "lora", "kitti", "waymo"),
                    default="ptv3")
    ap.add_argument("--fused", action="store_true", help="PTv3 with block_conv_fused=True")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pointcept_tpu_torch.engines import make_inputs, make_point_batch
    from pointcept_tpu_torch.models import build_model

    device = torch.device("cuda", 0)
    card = cs.nvidia_smi("name,power.limit")
    if args.model != "ptv3" and args.fused:
        ap.error("--fused applies to PTv3")
    if args.model == "spunet":
        eval_cfg, train_cfg, recipe = cs.SPUNET_MODEL, cs.SPUNET_MODEL, cs.SPUNET_RECIPE
    elif args.model in CONFIG_STEPS:
        args.train = True
    else:
        fused = dict(block_conv_fused=args.fused)
        eval_cfg = dict(cs.MODEL, backbone=dict(cs.MODEL["backbone"], **fused))
        train_cfg = dict(cs.TRAIN_MODEL, backbone=dict(cs.TRAIN_MODEL["backbone"], **fused))
        recipe = cs.PTV3_RECIPE
    if args.model in CONFIG_STEPS:
        step, data = config_step(cs, device, args.model, args.requests + 1)
        gen = torch.Generator(device=device).manual_seed(7)
        hyper = dict(mask_size=0.4, mask_ratio=0.7, teacher_temp=0.07, momentum=0.996)

        def run(arrays):
            if args.model == "sonata":
                step(make_inputs(arrays, device=device), gen, hyper)
            else:
                step(make_inputs(arrays, device=device), gen)
    elif args.train:
        # the same seed pairs again and again: a step's work hardly depends on them
        _, step = cs._train_setup(train_cfg, device, seed=0, recipe=recipe)
        pairs = [cs.TRAIN_SEEDS[i % len(cs.TRAIN_SEEDS)] for i in range(args.requests + 1)]
        data = [cs.scene(seeds, labelled=True) for seeds in pairs]
        gen = torch.Generator(device=device).manual_seed(7)

        def run(arrays):
            step(make_point_batch(arrays, 2, device=device), gen)
    else:
        model = build_model(eval_cfg, device=device, generator=torch.Generator().manual_seed(0))
        data = [cs.scene(seed) for seed in cs.SEEDS[: args.requests + 1]]

        def run(arrays):
            model(make_point_batch(arrays, 1, device=device))

    run(data[0])
    torch.cuda.synchronize()
    # calls that make the host wait for the card, in one request or step
    # (the batch's host-to-device copies included)
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(data[0])
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    print(json.dumps({"phase": "host_syncs", "per_request": len(syncs), "kinds": sorted(set(syncs))}))
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for arrays in data[1:]:
        run(arrays)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        for arrays in data[1:]:
            run(arrays)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0)
        # user annotations (the optimizer's step range) span kernels counted already
        if (dev and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            k = kernels.setdefault(evt.key, [0.0, 0])
            k[0] += dev / 1e3
            k[1] += evt.count
    busy_ms = sum(v[0] for v in kernels.values())
    cats = {}
    for name, (ms, _) in kernels.items():
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    n = args.requests
    # idle share against the unprofiled wall time of the same requests: the
    # profiler's own host cost stretches the profiled window
    print(json.dumps({"phase": "profile_window", "card": card, "model": args.model, "fused": args.fused,
                      "train": args.train, "requests": n,
                      "wall_ms_per_request": plain_wall_ms / n,
                      "profiled_wall_ms_per_request": wall_ms / n,
                      "device_busy_ms_per_request": busy_ms / n,
                      "device_idle_share": 1 - busy_ms / plain_wall_ms,
                      "peak_memory_bytes": peak}))
    print(json.dumps({"phase": "profile_categories", "ms_per_request": {
        c: ms / n for c, ms in sorted(cats.items(), key=lambda kv: -kv[1])}}))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    print(json.dumps({"phase": "profile_top", "kernels": [
        {"name": name[:120], "ms_per_request": ms / n, "launches_per_request": cnt / n}
        for name, (ms, cnt) in top[:15]]}))
    os.makedirs(args.out, exist_ok=True)
    name = "torch_port_profile" + f"_{args.model}" * (args.model != "ptv3") + "_fused" * args.fused
    name += "_train.txt" if args.train else ".txt"
    with open(os.path.join(args.out, name), "w") as f:
        f.write(f"{card}\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))
        f.write("\nBy input shape:\n")
        f.write(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_device_time_total", row_limit=40, max_name_column_width=40,
            max_shapes_column_width=120))
    return 0


# the config-driven train steps: the chip_smoke.py names of the config, its
# options and the collate's capacity
CONFIG_STEPS = {
    "sonata": lambda cs: (cs.SONATA_CONFIG, {}, cs.SONATA_OPTIONS["point_capacity"]),
    "probe": lambda cs: (cs.DOWNSTREAM_CONFIGS[0][1], {}, cs.DOWNSTREAM_OPTIONS["point_capacity"]),
    "utonia": lambda cs: (cs.UTONIA_CONFIGS[1][1], cs.UTONIA_OPTIONS, cs.DOWNSTREAM_OPTIONS["point_capacity"]),
    "lora": lambda cs: (cs.LORA_CONFIG, cs.LORA_OPTIONS, cs.DOWNSTREAM_OPTIONS["point_capacity"]),
    "kitti": lambda cs: (cs.KITTI_CONFIG, {"model.backbone.pool_capacity_factors": cs.OUTDOOR_POOL["kitti"]},
                         cs.OUTDOOR_CAPACITY["kitti"]),
    "waymo": lambda cs: (cs.WAYMO_CONFIG, {}, cs.OUTDOOR_CAPACITY["waymo"]),
}
# the outdoor steps' scans: the street seeds of their train splits
OUTDOOR_SEEDS = {"kitti": lambda cs: cs.KITTI_FRAMES["00"] + cs.KITTI_FRAMES["01"],
                 "waymo": lambda cs: cs.WAYMO_SPLITS["train"]}


def outdoor_sample(cs, sensor: str, seed: int) -> dict:
    """A ray-cast scan (`chip_smoke.lidar_scan`) as its dataset's `get_data`
    gives it: KITTI's labels through the learning map, Waymo's strength
    through tanh and its labels shifted to 0-21."""
    import numpy as np

    from pointcept_tpu_torch.datasets.semantic_kitti import SemanticKITTIDataset, map_labels

    sc = cs.lidar_scan(sensor, seed)
    if sensor == "kitti":
        return dict(coord=sc["coord"], strength=sc["strength"][:, None],
                    segment=map_labels(sc["raw"], SemanticKITTIDataset.get_learning_map(-1)))
    return dict(coord=sc["coord"], strength=np.tanh(sc["strength"][:, None]),
                segment=sc["raw"].astype(np.int32) - 1)


def config_step(cs, device, model_name: str, batches: int):
    """A config's train step on the card (`CONFIG_STEPS`) and `batches`
    collated batches of its train pipeline (`config_batches`)."""
    import torch

    from pointcept_tpu_torch.engines import build_train_step
    from pointcept_tpu_torch.models import apply_amp_policy, build_model
    from pointcept_tpu_torch.utils import build_optimizer, build_scheduler

    cfg, capacity = _config(cs, model_name)
    model = build_model(apply_amp_policy(dict(cfg.model), cfg.enable_amp), device=device,
                        generator=torch.Generator().manual_seed(0))
    optimizer = build_optimizer(dict(cfg.optimizer), model, cfg.param_dicts)
    step = build_train_step(model, optimizer, build_scheduler(dict(cfg.scheduler), optimizer, cs.TOTAL_STEPS))
    return step, config_batches(cs, model_name, batches)


def _config(cs, model_name: str):
    from pointcept_tpu_torch.utils.config import Config

    config, options, capacity = CONFIG_STEPS[model_name](cs)
    cfg = Config.fromfile(os.path.join(ROOT, config))
    cfg.merge_from_dict(options)
    return cfg, capacity


def config_batches(cs, model_name: str, batches: int) -> list:
    """`batches` batches of the config's train pipeline, two synthetic
    scenes each (phase 10's, or the outdoor steps' scans), collated into
    its capacity; raises where the collate would subsample."""
    import numpy as np

    from pointcept_tpu_torch.datasets import Compose, point_collate_fn, synthesize_scene

    cfg, capacity = _config(cs, model_name)
    pipeline = Compose(list(cfg.data.train.transform))
    outdoor = model_name in OUTDOOR_SEEDS
    seeds = OUTDOOR_SEEDS[model_name](cs) if outdoor else cs.SCANNET_SEEDS["train"]
    data = []
    for b in range(batches):
        np.random.seed(b)
        samples = []
        for s in (seeds[(2 * b) % len(seeds)], seeds[(2 * b + 1) % len(seeds)]):
            if outdoor:
                samples.append(pipeline(outdoor_sample(cs, model_name, s)))
                continue
            sc = synthesize_scene(s, num_points=cs.RAW_POINTS, num_classes=cs.NUM_CLASSES, extent=6.0)
            samples.append(pipeline(dict(coord=sc["coord"], color=sc["color"].astype(np.float32),
                                         normal=sc["normal"], segment=sc["segment"].astype(np.int32))))
        data.append(point_collate_fn(samples, capacity=capacity, drop_overflow=False))
    return data


if __name__ == "__main__":
    sys.exit(main())
