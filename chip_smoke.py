#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pointcept_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (Hopper) and the CUDA toolkit
(`nvcc`); builds the kernels of `pointcept_tpu_torch/csrc/` first. Phases,
each printing JSON lines:

1. device: torch version, the card's name and power limit;
2. build: the CUDA kernels, one nvcc per source, in parallel;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main paths (tables from a real synthetic scene): the attention
   forward at every stage's shapes of the eval forward and the train step
   (and at head dim 8, the overfit config's stage 0, zero-padded to 16),
   the forward and backward at Sonata's stage 0 (C 48, H 3) and stage 3
   (C 384, H 24) over the global views of 262,144 rows, at Utonia's
   head dim 18 (stage 0: C 54, H 3; stage 3: C 432, H 24) and at
   Concerto-large's LoRA fine-tune (stage 0: C 64, H 4; stage 4: C 768,
   H 48) over a fine-tune step's two scenes of 262,144 rows, ModelNet40's
   classifier (stage 0: C 32, H 2; stage 4: C 512, H 32; 32 clouds),
   the tiny classifier's head dim 4 at patch 64 (C 8-32, zero-padded to 16)
   and LitePT's attention stages at head dim 18 (stage 3: C 252, H 14;
   stage 4: C 504, H 28); the biased (RPE) forward and backward at the S3DIS
   RPE config's stages 0 and 4 (patch 128), their outputs, statistics and
   the table's gradient, each run twice and bit-identical, their memory
   under half of one dense bias,
   the backward at the train step's (K 1024) and, for the TPU's whole-K
   kernels, at K 128, both run twice at stage 0 and bit-identical; the
   fill and the take-back at 4^3 and 8^3
   blocks; the attention forward, the fill and the take-back at the
   tester's stage 0 (four fragments of 262,144 rows, 8^3 tiles at 1/32); the
   two as each other's VJP (`BlockFill`, `TakeBack` backward
   passes) in the sorted and the shuffled route and SpUNet's, the fused
   block conv (`tap_conv_fwd` forward and as the input gradient,
   `tap_conv_dw`) at PTv3's stage 0 and stem and SpUNet's levels 0 and 3
   and stem, and the gather conv's VJP; `tap_conv_dw` and the gather conv's
   VJP run twice and must be bit-identical;
4. times: kernel, plain version, one PyTorch library call computing the same
   function, and the least time the card could take (bound); the attention
   rows with their launches per forward or step, and each path's sum of
   launches x ms (the eval forward's and train step's shapes, the whole-K
   and head-dim-8 cases, ModelNet40's, and stage 0 at head dims 18 and 4;
   the other paths' shapes are checked and were timed by the slices that
   brought them);
5. the serving path: the PTv3-base ScanNet eval forward (`DefaultSegmentorV2`
   + `PT-v3m1`, 5 stages at full width, AMP bf16, block-dense convs with 4^3
   blocks) on distinct synthetic scenes of 102,400 points, with the launch
   counters of every kernel set to 0 just before and read just after;
6. the same port on the card and on the CPU (plain versions), small depth,
   same weights: logits compared;
7. the training path: the config's train step (drop path 0.3, shuffled
   orders, cross-entropy + Lovász, AdamW with the `block` lr group, OneCycle
   over 1,000 steps) on two labelled 102,400-point scenes per step, one
   warm-up step and 4 timed ones, launch counters set to 0 just before the
   timed steps and read just after;
8. one train step of the small-depth model on the card and on the CPU, same
   weights and batch: loss and per-tensor gradients compared, beside the
   CPU's own noise floor (the step again on inputs nudged by 1e-6);
9. SpUNet-v1m1 (`configs/scannet/semseg-spunet-v1m1-0-base.py`, full width
   and depth, 8^3 blocks, the fused block conv) on the same scenes: the
   serving path (phase 5's seeds), card against CPU at small depth, the
   train step (the config's recipe: cross-entropy, SGD with nesterov
   momentum, OneCycle; two scenes per step as phase 7) and card against
   CPU for one train step, each path with its launch counters set to 0
   just before it and read just after;
10. the config-driven trainer: `configs/scannet/semseg-pt-v3m1-0-base.py`
   unchanged in model, optimizer, scheduler and transforms, through
   `main_worker` (what `tools/torch_port_train.py` runs), on six synthetic
   scenes written in ScanNet's layout (train seeds 0-3, val seeds 5 and 6,
   ~409,600 raw points each): batch 2, capacity 262,144 (val too), 2
   epochs of 2 steps with Mix3D, an evaluation after each, 4 data workers,
   checkpoints every epoch, launch counters set to 0 just before and read
   just after; then the second epoch again through the CLI as a
   subprocess, resumed from `epoch_1.pth`: its losses against the first
   run's, bit for bit; then its steady state: one epoch of 4 steps (loop
   2), every step's batch and data time, and the trainer's own train step
   alone on batches of its loader, beside phase 7's bare step;
11. the tester: the config's test section unchanged (13 views, GridSample's
   test mode, fragments of one voxel grid sharing their geometry, four a
   forward) through `main_worker` of `tools/torch_port_test.py`, on phase
   10's `model_best.pth` and val scene 5 drawn at 25,600 raw points, at
   `point_capacity_test=262144`, launch counters set to 0 just before and
   read just after; nothing dropped, the preds' mass equals the fragment
   points' count and every point has a vote from every view;
12. the two overfit configs of `configs/synthetic/` (PTv3 with head dim 8,
   AMP, its second pooling's factor raised to 0.75; SpUNet) through the
   trainer for 100 steps: train loss < 0.05, val mIoU > 0.80, no point dropped; then the
   PTv3 config's own test section (Copy, GridSample `return_inverse`, the
   full-resolution mapping) through the tester on its trained weights:
   mIoU > 0.80, allAcc > 0.90, nothing dropped, a second `test()` from the
   cached preds gives the same result, and the same tester on the CPU
   agrees (summed preds, argmax, mIoU);
13. Sonata's pretraining: `configs/sonata/pretrain-sonata-v1m1-0-base.py`
   unchanged in model (PT-v3m2 encoder 48-512, depths 3/3/3/12/3, heads of
   4,096 x 512 x 4,096, 2 global and 4 local views, masking, AMP),
   schedule, transforms and hooks, through `main_worker` on phase 10's train
   scenes (batch 2, capacity 262,144, 2 epochs of 2 steps, checkpoints every
   epoch): finite losses, nothing dropped or subsampled, the hooks' values
   against SonataHook on the host and the cosine weight decay, every
   student parameter updated, `epoch_1.pth` holding the teacher, 72
   attention forwards and 48 backwards a step; then one more step, after
   which every teacher tensor is its EMA bit for bit; the second epoch
   resumed through the CLI (the same loss bits); a 4-step epoch; one
   small-depth step on the card against the CPU; and the supervised PT-v3m2
   config (`semseg-pt-v3m2-0-sonata-scratch.py`, block engine) for 4 steps
   at phase 10's cuts;
14. Sonata's downstream configs on phase 13's checkpoint (its student
   backbone through each config's `CheckpointLoader`), through `main_worker`
   at phase 10's cuts (4 steps, one evaluation): the linear probe `0a`
   (frozen encoder: its tensors the checkpoint's bit for bit, no attention
   backward, only the seg head trained), the decoder probe `0b`, the
   fine-tune `0c` and the data-efficient `0e0` (la20: an `la_file` of 20
   labelled points a scene, only those labels in the loss) and `0e4` (lr1:
   a one-line `lr_file`); the loaded keys (missing: the seg head alone, the
   decoder too for `0b`; unexpected: the teacher, the SSL heads, the mask
   token), peak memory and later steps' ms of each; then the probe's test
   section (13 views) through the test CLI's `main_worker` on one
   25,600-point val scene, on the per-fragment path;
15. Utonia's linear probe and fine-tune (`configs/utonia/semseg-utonia-v1m1-0{a,c}`:
   PT-v3m3, RoPE at base 10, head dim 18, widths 54-576) through
   `main_worker` at phase 14's cuts and `in_channels=6` (no Utonia
   checkpoint: random weights of seed 0), the attention forwards and
   backwards a step at D = 18, then one small-depth fine-tune step on the
   card against the CPU (f32);
16. ScanNet200's PTv3 config (`configs/scannet200/semseg-pt-v3m1-0-base.py`,
   a 200-class head) on phase 10's scenes (their `segment200.npy`) at
   phase 14's cuts, then its test section (13 views, the grouped path) on
   one 51,200-point val scene: nothing dropped, every point voted by every
   view, 200-way preds, the benchmark submission refused with the list it
   lacks;
17. S3DIS's SpUNet config (`configs/s3dis/semseg-spunet-v1m1-0-base.py`:
   SGD nesterov, PolyLR, ShufflePoint, GridSample at 4 cm) on synthetic
   offices of a million raw points in Areas 1-6: 4 steps at batch 2 (each
   step's lr against PolyLR's formula), one evaluation, the one-view test
   section on the Area_5 room at a `point_capacity_test` set from its voxel
   count, its `record.npz` read by `tools/test_s3dis_6fold.py`, and the
   tester refusing the room above its capacities (a fragment too large,
   pooled levels that drop points);
18. ScanNet++'s PTv3 config (`configs/scannetpp/semseg-pt-v3m1-0-base.py`,
   100 classes) on phase 10's scenes in ScanNet++'s layout, at phase 14's
   cuts;
19. Concerto-large's LoRA fine-tune
   (`configs/concerto/semseg-ptv3-large-v1m1-0f-scannet-ft-lora.py`: PT-v3m2
   at 64-768 channels, LoRA rank 16 on every qkv, the encoder frozen) at
   phase 14's cuts and `in_channels=6` from a random encoder saved in the
   reference's checkpoint layout: the missing keys exactly the adapters and
   the head, every frozen encoder tensor the checkpoint's bit for bit after
   the steps, every adapter and the head moved, 24 attention forwards and
   backwards a step; then one small-depth LoRA step on the card against the
   CPU (f32);
20. SemanticKITTI's PTv3 config (`configs/semantic_kitti/semseg-pt-v3m1-0-base.py`)
   on HDL-64E scans written by casting the sensor's rays against a street
   (`lidar_scan`, `write_kitti`: sequences 00-01 train, 08 val, 11 test) at
   phase 14's cuts and two scans a card: 4 steps, one evaluation, the
   geometry of two scans (the depth they serialize at, each pooled level's
   clusters against its capacity, no patch holding both scans), its test
   section (4 rotation views, the grouped path) on the val scan, then the
   test split's submission read back (uint32 `.label` files of raw ids);
21. nuScenes' PTv3 config on HDL-32E sweeps in the info layout: two epochs
   of 2 steps (its resumed epoch is left to phases 10, 13 and 29),
   its test section on the val sweep and the lidarseg submission of the
   test split (`<lidar token>_lidarseg.bin` of classes 1-16 and
   `test/submission.json`);
22. Waymo's PTv3 config on two-return top-lidar frames at 262,144 rows a
   frame (524,288 a step): 4 steps, one evaluation;
23. Utonia's nuScenes fine-tune (PT-v3m3, head dim 18) and Concerto-large's
   SemanticKITTI linear probe (frozen encoder, bit for bit after the steps)
   at serialize_depth 11, from random encoders saved under
   `student.backbone.` and `in_channels=4`, on phases 20-21's scans;
24. Point Prompt Training: PTv3's PPT-extreme config
   (`configs/scannet/semseg-pt-v3m1-1-ppt-extreme.py`: PPT-v1m1 over PT-v3m1
   at 48-512 with decoupled PDNorm on every norm, the block engine) through
   `main_worker` and `MultiDatasetTrainer` on synthetic Structured3D rooms
   (the config's loop 2) and phase 10's ScanNet scenes at phase 14's cuts:
   6 steps in the pattern Structured3D, Structured3D, ScanNet, the loader's
   length its steps, 30 attention forwards and backwards a step, nothing
   dropped at any pooling; bare steps of each condition, after which only
   that condition's norms moved and only its row of the context table has a
   gradient; the test section on a 102,400-point ScanNet val scene (the
   grouped path, every forward at ScanNet); then one small-depth step on
   the card against the CPU (f32);
25. the SpUNet PPT config (`configs/scannet/semseg-ppt-v1m1-0-sc-st-spunet.py`:
   SpUNet-v1m3, adaptive PDNorm, SGD) on the same data: 4 steps, one
   evaluation, the same per-condition checks and the modulation's
   gradient;
26. PointGroup over PTv3-base (`configs/scannet/insseg-pointgroup-v1m2-0-ptv3-base.py`:
   PG-v1m2 over PT-v3m1, the gather engine) through `main_worker` on phase
   10's scenes at phase 14's cuts (the first pooling at 0.65): a later
   step's ms, data time and peak, the three loss terms, 22 attention
   forwards and backwards a step, InsSegEvaluator's AP, proposals and host
   clustering ms a scene, every tensor moved, nothing dropped at any
   pooling; the config's InsSegTester on val scene 5; then one small-depth
   step on the card against the CPU (f32, 4,096 points);
27. the SpUNet PointGroup config (`configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py`:
   its model, SGD + PolyLR and transforms) overfitting one synthetic 3 m
   room for 75 steps, then InsSegEvaluator on that room: AP50 above 0.5;
28. Sonata's PointGroup linear probe (`configs/sonata/insseg-sonata-v1m1-0a-scannet-pg-lin.py`)
   on phase 13's checkpoint at phase 14's cuts: the missing and
   unexpected keys, every backbone tensor as loaded bit for bit (the
   decoder at its seeded init), no attention backward, the bias and seg
   heads alone trainable and moved;
29. ModelNet40's PTv3 classifier (`configs/modelnet40/cls-pt-v3m1-0-base.py`:
   `DefaultClassifier` over PT-v3m1 enc_mode at 32-512, depths 2/2/2/6/2,
   patch 1024, AdamW + CosineAnnealingLR) through `main_worker` on
   synthetic clouds written in the `modelnet40_normal_resampled` layout
   (`write_modelnet`: 10,000 points with normals a file, 40 class shapes),
   at the config's batch of 32 clouds: two 4-step epochs (an evaluation and
   a checkpoint each), a later step's ms, data time and peak, 14 attention
   forwards and backwards a step, each stage's rows against its patch
   (every cloud at most one patch), ClsEvaluator's allAcc, every tensor
   moved, nothing dropped; the second epoch resumed through the CLI (the
   same loss bits); ClsTester on the 40 test clouds and the voting
   config's ClsVotingTester (100 repeats) on 1, ms a cloud; then one
   small-depth step on the card against the CPU (f32, 4 clouds);
30. the synthetic tiny classifier (`configs/synthetic/cls-pt-v3m1-0-tiny.py`:
   head dim 4 at patch 64, on the D = 16 kernels) as written and for 120
   steps: allAcc on its val split against 0.9 (a convergence figure,
   reported), beside the same weights on each batch's own norm statistics;
31. Utonia's ShapeNet-Part fine-tune (`configs/utonia/partseg-utonia-v1m1-9b-shapenet-ft.py`:
   PT-v3m3 at 54-576 with RoPE, head dim 18, 9 feature channels) from a
   random encoder saved under `student.backbone.`, on synthetic shapes in
   ShapeNet-Part's layout (`write_shapenet`: ~2,500 points, 16 categories,
   the standard 50-part ranges) at the config's batch of 16: 4 steps and
   one evaluation (24 attention forwards and backwards a step, the loaded
   and missing keys), then the config's ShapeNetPartSegTester on 16 test
   shapes (ins.mIoU, cat.mIoU, ms a shape);
32. the ScanNet PT-v2m2 config (`configs/scannet/semseg-pt-v2m2-0-base.py`:
   48-512 channels, depths 2/2/6/2, kNN of 16, GridPool at 0.06-0.9375 m,
   AdamW + OneCycle, drop path 0.3) as written in model and recipe at
   phase 14's cuts on phase 10's scenes: one 4-step epoch and its
   evaluation, a later step's ms, data time and peak, every tensor moved;
   two steps from one state with the same loss and gradient bits, each
   kNN of a forward timed alone (ms a step, share of the step), each
   GridPool's clusters against its capacity (nothing dropped); then the
   config's test section on one val scene of 12,800 raw points (one
   forward a fragment, every point voted by every view);
33. PT-v2m2 and PT-v2m1 (grouped linear, position multiplier) at one block
   a stage, f32, on the card against the CPU on a 6,144-point scene of
   5.4 m (every stage above k points, nothing dropped): logits, then one
   train step's loss and gradients;
34. the Context-Aware Classifier's ScanNet configs over SpUNet (4 steps)
   and over PT-v2m2 (2 steps): the four loss terms of every step, step ms,
   peak, one evaluation each;
35. the S3DIS RPE config (`configs/s3dis/semseg-pt-v3m1-1-rpe.py`: PT-v3m1-base
   at patch 128 with a relative-position table in every block, the block
   engine) on phase 17's offices at phase 14's cuts: 4 steps and one
   evaluation, 22 biased attention forwards and backwards a step on their
   own counters, every tensor moved (the tables among them), nothing
   dropped;
36. LitePT-v1 at its class defaults (widths 36-504, head dim 18) through the
   ScanNet LitePT config's data, transforms and recipe on phase 10's scenes
   at phase 14's cuts: 4 steps, one evaluation, 8 attention forwards and
   backwards a step, every tensor moved, nothing dropped;
37. its test section on one val scene of 12,800 raw points (every point
   voted by every view);
38. LitePT and PT-v3m1 with RPE at one block a stage, f32, on the card
   against the CPU: logits, then one train step;
39. one {"kernels": [...]} line (launches: the training paths', PTv3's for
   its four kernels and SpUNet's for the fused block conv's two, phases
   20-24, 26, 28 and 29's added to the attention rows and phase 24's to the
   fill and the take-back; the D = 18 rows: phase 15's fine-tune, phase
   23's Utonia fine-tune and phase 31's, and phase 36's LitePT; the D = 4
   rows: phase 30's; the biased rows: phase 35's).

Each phase prints its own seconds. The CPU sides of the card-vs-CPU phases
(6, 8, 9, 13, 15, 19, 24, 26, 29, 33, 38) run in a spawned worker process
ahead of their phases, beside the card's work; the resumed epochs of
phases 10, 13 and 29 (CLI children, mostly start-up) run beside phases
11-12, 17 and 29's testers.

The last line is {"ok": true, "device": {...}}. Any failure raises and exits
nonzero; nothing falls back to the CPU. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# PTv3-base geometry of the repository's ScanNet forward benchmark, one scene
# of 102,400 points per request
CAPACITY = 102400
BACKBONE = dict(
    type="PT-v3m1",
    in_channels=6,
    order=("z", "z-trans", "hilbert", "hilbert-trans"),
    stride=(2, 2, 2, 2),
    enc_depths=(2, 2, 2, 6, 2),
    enc_channels=(32, 64, 128, 256, 512),
    enc_num_head=(2, 4, 8, 16, 32),
    enc_patch_size=(1024,) * 5,
    dec_depths=(2, 2, 2, 2),
    dec_channels=(64, 64, 128, 256),
    dec_num_head=(4, 4, 8, 16),
    dec_patch_size=(1024,) * 4,
    mlp_ratio=4,
    drop_path=0.0,
    serialize_depth=10,
    pool_capacity_factors=(0.35, 0.25, 0.25, 0.25),
    conv_engine="block",
    scene_blocked=False,
    block_bits=2,
    block_capacity_factor=(1 / 11, 1 / 15, 1 / 15, 1 / 15, 1 / 15),
    amp=True,
)
NUM_CLASSES = 20
MODEL = dict(type="DefaultSegmentorV2", num_classes=NUM_CLASSES, backbone_out_channels=64, backbone=BACKBONE,
             criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
# one warm-up request, then the timed ones. Seeds 4 and 9 are left out: their
# scenes overflow the benchmark's static pool and block capacities (PERF.md)
SEEDS = (0, 1, 2, 3, 5, 6, 7, 8, 100)
REQUESTS = len(SEEDS) - 1
# published H100 SXM peaks (dense): bf16 tensor cores, HBM; the SFU's exp rate per SM and clock
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
EXP_PER_CLOCK_PER_SM = 16
# card-vs-CPU bounds of the whole slice (tests/test_torch_port_ptv3.py)
SLICE_BOUNDS = {False: (1e-2, 0.99), True: (5e-2, 0.97)}
# the config's train recipe (configs/scannet/semseg-pt-v3m1-0-base.py) at the
# benchmark geometry: two scenes of 102,400 points per step. Each pair of
# seeds is one step: a warm-up, then the timed ones (seeds 4 and 9 overflow)
TRAIN_MODEL = dict(MODEL, backbone=dict(BACKBONE, drop_path=0.3, shuffle_orders=True),
                   criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
                             dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0,
                                  ignore_index=-1)])
OPTIMIZER = dict(type="AdamW", lr=0.006, weight_decay=0.05)
PARAM_DICTS = [dict(keyword="block", lr=0.0006)]
SCHEDULER = dict(type="OneCycleLR", max_lr=[0.006, 0.0006], pct_start=0.05, anneal_strategy="cos",
                 div_factor=10.0, final_div_factor=1000.0)
TOTAL_STEPS = 1000
PTV3_RECIPE = dict(optimizer=OPTIMIZER, param_dicts=PARAM_DICTS, scheduler=SCHEDULER)
EVAL_KERNELS = ("patch_attention", "block_fill", "take_back")
TRAIN_KERNELS = ("patch_attention", "patch_attention_bwd", "block_fill", "take_back")
TRAIN_SEEDS = ((0, 1), (2, 3), (5, 6), (7, 8), (100, 1000))
# SpUNet-v1m1 of configs/scannet/semseg-spunet-v1m1-0-base.py on the block
# engine with 8^3 blocks and the fused block conv (the same scenes; no seed
# overflows its capacities), and the config's recipe
SPUNET = dict(type="SpUNet-v1m1", in_channels=6, num_classes=NUM_CLASSES,
              channels=(32, 64, 128, 256, 256, 128, 96, 96), layers=(2, 3, 4, 6, 2, 2, 2, 2),
              serialize_depth=11, pool_capacity_factor=0.5, conv_engine="block",
              block_capacity_factor=1 / 16, block_engine_min_points=8192, block_conv_fused=True)
SPUNET_MODEL = dict(type="DefaultSegmentor", backbone=SPUNET,
                    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
SPUNET_RECIPE = dict(
    optimizer=dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=0.0001, nesterov=True),
    param_dicts=None,
    scheduler=dict(type="OneCycleLR", max_lr=0.05, pct_start=0.05, anneal_strategy="cos",
                   div_factor=10.0, final_div_factor=10000.0))
SPUNET_EVAL_KERNELS = ("block_fill", "take_back", "tap_conv_fwd")
SPUNET_TRAIN_KERNELS = ("block_fill", "take_back", "tap_conv_fwd", "tap_conv_dw")
# the config-driven trainer's phase: the ScanNet config's own path, six
# synthetic scenes in ScanNet's layout (seeds 4 and 9 overflow), and the
# options that cut it to size (PERF.md §4)
SCANNET_CONFIG = "configs/scannet/semseg-pt-v3m1-0-base.py"
SCANNET_SEEDS = {"train": (0, 1, 2, 3), "val": (5, 6)}
RAW_POINTS = 409600
TRAINER_OPTIONS = dict(batch_size=2, point_capacity=262144, point_capacity_val=262144, epoch=2, eval_epoch=2,
                       num_worker=4, seed=0, **{"hooks.4.save_freq": 1})
# a longer epoch of the same run for the trainer's steady state: loop 2
# (epoch // eval_epoch), 4 steps, one evaluation (cut from 8 steps and 6
# bare steps to leave the time limit room for phases 26-28)
STEADY_OPTIONS = dict(epoch=2, eval_epoch=1)
STEADY_STEPS = 4
BARE_STEPS = 4
# the overfit configs and their options: their point_capacity (4,096) is per
# chip, where the JAX package spreads the batch of 8 scenes over 8 chips, so
# one card holds the batch at 8 x 4,096; PTv3's second pooling keeps ~11,300
# of its 16,384 rows, above the config's factor 0.5, and would drop ~3,000
# points a step
# 100 of the configs' 150 steps, for the time limit (both losses were under
# 0.05 by step 50 at 150)
OVERFIT_CONFIGS = {
    "configs/synthetic/semseg-pt-v3m1-1-overfit.py":
        {"point_capacity": 32768, "model.backbone.pool_capacity_factors": (0.5, 0.75), "epoch": 100},
    "configs/synthetic/semseg-spunet-v1m1-1-overfit.py": {"point_capacity": 32768, "epoch": 100},
}
# the overfit config's stage-0 attention (head dim 8): that batch in patches
# of 128, its encoder and decoder block a step
OVERFIT_ATTENTION = dict(capacity=32768, scenes=8, k=128, c=16, h=2, launches=2)
# the tester's phase: the ScanNet config's test section on phase 10's
# weights and val scene 5 drawn at TESTER_POINTS raw points (its 409,600-point
# draw took 144 s, most of it the loader's fragment build; cut for the time
# limit to 102,400, then to 25,600 for phases 32-34; phase 24's PPT test
# takes the same scene), at a capacity that holds a fragment without drops (the config's
# 131,072 is per chip; at it a fragment of the sparse synthetic scene drops
# points at the second pooling); B fragments a forward, the tester's default.
# Phases 3-4's tester rows keep the 409,600-point scene's stage 0
TESTER_SCENE = "scene0005_00"
TESTER_POINTS = 25600
TESTER_OPTIONS = {"point_capacity_test": 262144, "seed": 0}
TESTER_B = 4
# card-vs-CPU bounds of the overfit tester's summed preds (AMP: the slice's
# logit bound; argmax and mIoU as the CPU tests of the tester)
TESTER_CPU_BOUNDS = dict(rel=5e-2, agreement=0.99, miou=0.02)
# small depth for the card-vs-CPU phases: one block a stage, the block engine
# from 4,096 points (levels 0-2 of a 16,384-point scene)
SPUNET_SMALL = dict(SPUNET, layers=(1,) * 8, block_engine_min_points=4096)
# phase 13: Sonata's self-distillation pretraining config, unchanged in
# model, schedule, transforms and hooks, on phase 10's train scenes, and the
# options that cut it to one card (PERF.md §4): the config's batch of 96 and
# its 131,072 rows are per chip over many chips; two scenes need 262,144
# rows (two global views of up to 65,536 points each a scene); save every
# epoch for the resume
SONATA_CONFIG = "configs/sonata/pretrain-sonata-v1m1-0-base.py"
SONATA_OPTIONS = dict(batch_size=2, point_capacity=262144, num_worker=4, seed=0, epoch=2, eval_epoch=2,
                      **{"hooks.5.save_freq": 1})
SONATA_STEADY = dict(epoch=2, eval_epoch=1)  # STEADY_STEPS steps
SONATA_POOL = (0.5, 0.5, 0.5, 0.5)  # PT-v3m2's pooling factors, which the config keeps
SONATA_VIEWS = (2, 4)  # global and local views a scene
# Sonata's attention at its stage 0 and its 12-block stage 3: (stage, C, H,
# forward launches a step: the stage's blocks in three forwards)
SONATA_ATTENTION = ((0, 48, 3, 9), (3, 384, 24, 36))
# teacher tensors whose EMA the phase reports by name
SONATA_EMA_NAMES = ("teacher.backbone.embedding.stem.linear.weight",
                    "teacher.backbone.enc.enc3.block11.attn.qkv.weight", "teacher.mask_head.prototype.weight_v")
# the supervised PT-v3m2 config (linear stem, decoder, the ScanNet base's
# block engine) at phase 10's cuts
SCRATCH_CONFIG = "configs/scannet/semseg-pt-v3m2-0-sonata-scratch.py"
# phase 14: Sonata's downstream configs on phase 13's own checkpoint (its
# student backbone, by the configs' CheckpointLoader), at phase 10's cuts:
# 4 steps (loop 2 of one epoch: epoch // eval_epoch) and one evaluation
# each; the lr1 fine-tune's one scene takes loop 4 for its 2 steps
DOWNSTREAM_CONFIGS = (
    ("0a", "configs/sonata/semseg-sonata-v1m1-0a-scannet-lin.py"),
    ("0b", "configs/sonata/semseg-sonata-v1m1-0b-scannet-dec.py"),
    ("0c", "configs/sonata/semseg-sonata-v1m1-0c-scannet-ft.py"),
    ("0e0", "configs/sonata/semseg-sonata-v1m1-0e0-scannet-ft-la20.py"),
    ("0e4", "configs/sonata/semseg-sonata-v1m1-0e4-scannet-ft-lr1.py"),
)
DOWNSTREAM_OPTIONS = dict(batch_size=2, point_capacity=262144, point_capacity_val=262144, epoch=2, eval_epoch=1,
                          num_worker=4, seed=0)
LA_POINTS = 20  # labelled points a scene of the la20 benchmark
LR_SCENES = ("scene0001_00",)  # the lr file: one line (the JAX package cannot read it)
# the test sections of phases 14 and 16 on one val scene of 25,600 raw
# points (the per-fragment path runs one forward a fragment: the
# 409,600-point scene's ~550 fragments would pass the time limit), phase
# 14's linear probe at half that (its 102,400 points took 26-32 s of the
# time limit; both halved again for phases 32-34's room, and again for
# phases 35-38's: at 51,200 and 25,600 they took 17.7 and 27.8 s on an H100)
PROBE_TEST_SCENE = "scene0007_00"
PROBE_TEST_POINTS = 25600
PROBE_TESTER_POINTS = 12800
# phase 15: Utonia's linear probe and fine-tune (PT-v3m3, RoPE, head dim 18)
# at phase 14's cuts; its in_channels=9 differs from the 6 channels its
# data section collects
UTONIA_CONFIGS = (("0a", "configs/utonia/semseg-utonia-v1m1-0a-scannet-lin.py"),
                  ("0c", "configs/utonia/semseg-utonia-v1m1-0c-scannet-ft.py"))
UTONIA_OPTIONS = {"model.backbone.in_channels": 6}
# Utonia's attention at head dim 18 (zero-padded onto the D = 24 kernels):
# stage 0 (C 54, H 3) and the 12-block stage 3 (C 432, H 24) of a fine-tune
# step's two scenes of 262,144 rows: (stage, C, H, launches a step, forward
# and backward)
UTONIA_ATTENTION = ((0, 54, 3, 3), (3, 432, 24, 12))
UTONIA_POOL = (0.5, 0.5, 0.5, 0.5)
# phase 16: ScanNet200's PTv3 config (the 200-class head) at phase 14's cuts
# on phase 10's scenes, which carry a segment200.npy beside segment20.npy
# as preprocessed ScanNet does; then its test section (13 views, the
# grouped path) on one val scene of PROBE_TEST_POINTS raw points at phase
# 11's capacity
SCANNET200_CONFIG = "configs/scannet200/semseg-pt-v3m1-0-base.py"
# phase 17: S3DIS with SpUNet (SGD nesterov, PolyLR, ShufflePoint, GridSample
# at 4 cm) on synthetic offices of about a million raw points, the scanner's
# density: 8 train rooms in Areas 1-4 and 6 (4 steps at batch 2, one
# evaluation) and one Area_5 room for val and the one-view test section;
# the batch of two rooms needs 262,144 rows (the config's 131,072 is per
# chip over a batch of 12)
S3DIS_CONFIG = "configs/s3dis/semseg-spunet-v1m1-0-base.py"
S3DIS_ROOMS = {"Area_1": 2, "Area_2": 2, "Area_3": 1, "Area_4": 2, "Area_5": 1, "Area_6": 1}
S3DIS_ROOM_POINTS = 1_000_000
S3DIS_CLASSES = ("ceiling", "floor", "wall", "beam", "column", "window", "door", "table", "chair", "sofa",
                 "bookcase", "board", "clutter")
S3DIS_OPTIONS = dict(batch_size=2, point_capacity=262144, epoch=1, eval_epoch=1, num_worker=4, seed=0)
# phase 18: ScanNet++'s PTv3 config (100 classes) at phase 14's cuts, on
# phase 10's scenes in ScanNet++'s layout (a 1-d segment.npy)
SCANNETPP_CONFIG = "configs/scannetpp/semseg-pt-v3m1-0-base.py"
# phase 19: Concerto-large LoRA fine-tuning (PT-v3m2 at 64-768 channels over
# heads 4-48, LoRA rank 16 on every qkv, the encoder frozen) at phase 14's
# cuts and in_channels=6, on a random encoder saved in the reference's
# checkpoint layout (the repository holds no Concerto checkpoint)
LORA_CONFIG = "configs/concerto/semseg-ptv3-large-v1m1-0f-scannet-ft-lora.py"
LORA_OPTIONS = {"model.backbone.in_channels": 6}
# its attention at the new shapes: stage 0 (C 64, H 4) and stage 4 (C 768,
# H 48) of a step's two scenes of 262,144 rows, (stage, C, H, launches a
# step, forward and backward)
LORA_ATTENTION = ((0, 64, 4, 3), (4, 768, 48, 3))
LORA_POOL = (0.5, 0.5, 0.5, 0.5)
# phases 20-23: outdoor lidar scans, written by casting the rays of each
# dataset's sensor from its public specification (beams, elevation span,
# azimuth steps a turn, returns, mounting height, range) against a street of
# primitives (`street`): the ring pattern, dense near the sensor and sparse
# far away, is what decides how far pooling shrinks a scan
LIDARS = {
    "kitti": dict(beams=64, elevation=(2.0, -24.9), steps=2000, returns=1, height=1.73, max_range=120.0),
    "nuscenes": dict(beams=32, elevation=(10.67, -30.67), steps=1090, returns=1, height=1.84, max_range=100.0),
    "waymo": dict(beams=64, elevation=(2.4, -17.6), steps=2650, returns=2, height=2.2, max_range=75.0),
}
# each dataset's raw label ids of the street's classes (SemanticKITTI's
# semantic-kitti.yaml ids, the nuScenes lidarseg categories, Waymo's 1-22)
LIDAR_LABELS = {
    "kitti": dict(road=40, lane=40, curb=48, sidewalk=48, terrain=72, building=50, car=10, moving_car=252, pole=80,
                  vegetation=70, trunk=71, person=30, unlabeled=0),
    "nuscenes": dict(road=24, lane=24, curb=26, sidewalk=26, terrain=27, building=28, car=17, moving_car=17,
                     pole=28, vegetation=30, trunk=30, person=2, unlabeled=0),
    "waymo": dict(road=18, lane=19, curb=17, sidewalk=22, terrain=21, building=14, car=1, moving_car=1, pole=10,
                  vegetation=15, trunk=16, person=7, unlabeled=0),
}
REFLECTIVITY = dict(road=0.12, lane=0.7, curb=0.25, sidewalk=0.22, terrain=0.18, building=0.3, car=0.45,
                    moving_car=0.45, pole=0.4, vegetation=0.2, trunk=0.15, person=0.25)
# phase 20-22's configs, and the street seeds of each sequence or split:
# SemanticKITTI sequences 00-01 (train), 08 (val), 11 (test, no labels);
# nuScenes and Waymo splits as their configs name them
KITTI_CONFIG = "configs/semantic_kitti/semseg-pt-v3m1-0-base.py"
NUSCENES_CONFIG = "configs/nuscenes/semseg-pt-v3m1-0-base.py"
WAYMO_CONFIG = "configs/waymo/semseg-pt-v3m1-0-base.py"
KITTI_FRAMES = {"00": (1, 2), "01": (3, 4), "08": (5,), "11": (6,)}
NUSCENES_SPLITS = {"train": (1, 2, 3, 4), "val": (5,), "test": (6,)}
WAYMO_SPLITS = {"train": (1, 2, 3, 4), "val": (5,)}
# phase 14's cuts (batch 2, 4 steps, one evaluation); the capacities hold
# two scans a card (the configs' are per chip, one scan each): KITTI
# 262,144, nuScenes 131,072, Waymo 524,288 rows a step
OUTDOOR_OPTIONS = dict(batch_size=2, epoch=2, eval_epoch=1, num_worker=4, seed=0)
OUTDOOR_CAPACITY = {"kitti": 262144, "nuscenes": 131072, "waymo": 524288}
# the pooling factors the KITTI and nuScenes phases run at: the configs' own
# (0.4 and 0.45 at every level) drop points of two sensor-pattern scans at
# levels 2-4 (level 1 too for KITTI); Waymo's 0.45 keep every point
OUTDOOR_POOL = {"kitti": (0.5, 0.5, 0.5, 0.5), "nuscenes": (0.55, 0.55, 0.55, 0.55)}
# phase 23: Utonia's nuScenes fine-tune (PT-v3m3, head dim 18) and
# Concerto-large's SemanticKITTI linear probe (PT-v3m2 at 64-768, frozen),
# both at serialize_depth 11, on random encoders saved under
# `student.backbone.`; their in_channels=9 over the 4 channels (coord,
# strength) the data section collects
OUTDOOR_PROBES = (("utonia_4c", "configs/utonia/semseg-utonia-v1m1-4c-nuscenes-ft.py", "nuscenes"),
                  ("concerto_4a", "configs/concerto/semseg-ptv3-large-v1m1-kitti-4a-lin.py", "kitti"))
OUTDOOR_PROBE_OPTIONS = {"model.backbone.in_channels": 4}
# the attention at the outdoor shapes: Waymo's stage 0 at two scans of
# 262,144 rows (encoder C 32 / H 2 and decoder C 64 / H 4) and nuScenes'
# stage 4 (C 512, H 32), launches a step, forward and backward
OUTDOOR_ATTENTION = (("waymo", 0, 32, 2, 2), ("waymo", 0, 64, 4, 2), ("nuscenes", 4, 512, 32, 2))
OUTDOOR_ATTENTION_POOL = {"waymo": (0.45,) * 4, "nuscenes": OUTDOOR_POOL["nuscenes"]}
# phases 24-25: Point Prompt Training, Structured3D (the config's loop 2)
# with ScanNet: PTv3's PPT-extreme config (PT-v3m1 48-512, depths 3/3/3/6/3
# and 3/3/3/3, decoupled PDNorm on every norm, the block engine) and the
# SpUNet PPT config (SpUNet-v1m3, adaptive PDNorm, the gather engine), both
# under PPT-v1m1, at phase 14's cuts: batch 2, 262,144 rows, epoch 2 over
# eval_epoch 1 (the concat's loop 2: the Structured3D loader's batches
# decide the epoch), one evaluation on one ScanNet val scene. Phase 24's
# four Structured3D rooms give 4 // 2 * 3 = 6 steps (S3D, S3D, ScanNet
# twice), phase 25's three 3 // 2 * 3 + 1 = 4
PPT_CONFIG = "configs/scannet/semseg-pt-v3m1-1-ppt-extreme.py"
PPT_SPUNET_CONFIG = "configs/scannet/semseg-ppt-v1m1-0-sc-st-spunet.py"
PPT_OPTIONS = dict(batch_size=2, point_capacity=262144, point_capacity_val=262144, epoch=2, eval_epoch=1,
                   num_worker=4, seed=0)
PPT_S3D_SEEDS = (20, 21, 22, 23)
PPT_STEPS = {PPT_CONFIG: 6, PPT_SPUNET_CONFIG: 4}
# the first pooling's capacity raised from the configs' 0.4 (PT-v3) and 0.5
# (SpUNet's one factor) to 0.65: two rooms cropped at SphereCrop's 0.8 and
# subsampled into 262,144 rows keep 0.41-0.56 of their rows at stride 2
# (phase 24's `geometry`), where the configs' capacities are per chip for
# one room; the later levels keep 0.2-0.28 and fit the configs' 0.4
PPT_POOL_OPTIONS = {PPT_CONFIG: {"model.backbone.pool_capacity_factors": (0.65, 0.4, 0.4, 0.4)},
                    PPT_SPUNET_CONFIG: {"model.backbone.pool_capacity_factor": 0.65}}
PPT_PATTERN = ("Structured3D", "Structured3D", "ScanNet")
S3D_CLASSES = 25
# PPT-extreme's attention at its new widths: stage 0 (C 48, H 3) and stage 4
# (C 512, H 32) of a step's two scenes of 262,144 rows at its pooling 0.4,
# (stage, C, H, launches a step, forward and backward)
PPT_ATTENTION = ((0, 48, 3, 3), (4, 512, 32, 3))
PPT_POOL = (0.4, 0.4, 0.4, 0.4)
# phase 26: the PTv3 PointGroup config (PG-v1m2 over PT-v3m1 at PTv3-base's
# widths, the gather engine, AdamW + OneCycle) at phase 14's cuts on phase
# 10's scenes, then its InsSegTester (on data.val) on val scene 5 alone
INSSEG_CONFIG = "configs/scannet/insseg-pointgroup-v1m2-0-ptv3-base.py"
# its train pipeline crops each room at SphereCrop's 0.8 (no point cap), so
# two rooms fill the 262,144 rows and the first pooling keeps more than the
# config's 0.4 of them, as phase 24's rooms: the first pooling at 0.65
INSSEG_POOL_OPTIONS = {"model.backbone.pool_capacity_factors": (0.65, 0.4, 0.4, 0.4)}
# phase 27: the SpUNet PointGroup config's own model, SGD + PolyLR and
# transforms on one synthetic scene of a 3 m room, INSSEG_OVERFIT_OPTIONS'
# steps of one scene (the loop of one epoch), then InsSegEvaluator on that scene
INSSEG_OVERFIT_CONFIG = "configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py"
# (the val pipeline does not crop: the whole scene's ~30k voxels pool into
# more than 0.5 of 32,768 rows, so the val batch has 65,536)
# 75 steps (150 before, for the time limit: AP50 0.0 at 150, a convergence
# figure the run reports)
INSSEG_OVERFIT_OPTIONS = dict(batch_size=1, batch_size_val=1, point_capacity=32768, point_capacity_val=65536,
                              epoch=75, eval_epoch=1, num_worker=4, seed=0)
INSSEG_OVERFIT_SCENE = dict(seed=31, points=30000, extent=3.0)
INSSEG_OVERFIT_AP50 = 0.5
# phase 28: Sonata's PointGroup linear probe (PT-v3m2 with a decoder, frozen,
# under PG-v1m2) on phase 13's checkpoint at phase 14's cuts
INSSEG_PROBE_CONFIG = "configs/sonata/insseg-sonata-v1m1-0a-scannet-pg-lin.py"
# phase 29: ModelNet40's PTv3 classifier (PT-v3m1 enc_mode 32-512, depths
# 2/2/2/6/2, patch 1024) at the config's batch of 32 clouds on one card, on
# synthetic clouds in the modelnet40_normal_resampled layout
# the attention paths phase 4 times (every shape of every path is checked)
TIMED_PATHS = ("eval", "train", "patch 128", "overfit train", "modelnet", "litept")
CLS_CONFIG = "configs/modelnet40/cls-pt-v3m1-0-base.py"
CLS_VOTING_CONFIG = "configs/modelnet40/cls-pt-v3m1-1-voting.py"
CLS_FILE_POINTS = 10000  # points a file (with normals)
CLS_SPLITS = {"train": 128, "test": 40}  # 4 steps of 32 clouds; the test split is also the config's val
CLS_VOTE_CLOUDS = 1  # cut from 4 (5.6 s a cloud) for the time limit's room for phases 32-34
# the config's 8,192 rows hold 4 clouds (a TPU device's share); 32 clouds
# of 1,024 points take 32,768, and a val batch of 8 clouds 8,192. Its
# pooling of 0.6 a stage drops points of FPS-spread clouds, whose points
# stay apart until the voxels grow to their spacing (32 clouds: 100%,
# 99.5%, 72% and 31% of the last stage's points a stage; one cloud up to
# 94% at stage 3): 1.0 at stages 1-3, the config's 0.6 at stage 4
CLS_OPTIONS = dict(batch_size=32, point_capacity=32768, point_capacity_val=8192, point_capacity_test=1024,
                   epoch=2, eval_epoch=2, num_worker=4, seed=0,
                   **{"hooks.4.save_freq": 1, "model.backbone.pool_capacity_factors": (1.0, 1.0, 1.0, 0.6)})
CLS_ATTENTION = ((0, 32, 2, 2), (4, 512, 32, 2))  # (stage, C, H, launches a step) of phase 4's rows
CLS_CAPACITY, CLS_SCENES = 32768, 32
# phase 30: the synthetic tiny classifier (head dim 4, patch 64), its
# pooling raised to 1.0 (the config's 0.6 drops whole clouds): as written,
# then 120 steps (30 epochs of 4) as its convergence figure
CLS_TINY_CONFIG = "configs/synthetic/cls-pt-v3m1-0-tiny.py"
CLS_TINY_OPTIONS = dict(seed=0, **{"model.backbone.pool_capacity_factors": (1.0, 1.0)})
CLS_TINY_STEPS = 120
CLS_TINY_ALLACC = 0.9
CLS_TINY_ATTENTION = ((0, 8, 2, 1), (1, 16, 4, 1), (2, 32, 8, 1))  # K 64, 8 clouds of 2,048 rows
# phase 31: Utonia's ShapeNet-Part fine-tune (PT-v3m3, head dim 18, widths
# 54-576, 9 feature channels) at the config's batch of 16 shapes
PARTSEG_CONFIG = "configs/utonia/partseg-utonia-v1m1-9b-shapenet-ft.py"
PARTSEG_SPLITS = {"train": 64, "val": 16, "test": 16}
PARTSEG_POINTS = 2500
# the model's pooling of 0.5 a stage drops points (16 shapes: 92%, 73%, 45%
# and 28% of the last stage's points a stage; one shape up to 87% at stage
# 2 and 61% at stage 3): 1.0 at stages 1-2, 0.75 at 3, the 0.5 at 4
PARTSEG_OPTIONS = dict(batch_size=16, batch_size_val=4, point_capacity=40960, point_capacity_val=12288,
                       point_capacity_test=4096, epoch=1, eval_epoch=1, num_worker=4, seed=0,
                       **{"model.backbone.pool_capacity_factors": (1.0, 1.0, 0.75, 0.5)})
SHAPENET_SYNSETS = {
    "Airplane": "02691156", "Bag": "02773838", "Cap": "02954340", "Car": "02958343", "Chair": "03001627",
    "Earphone": "03261776", "Guitar": "03467517", "Knife": "03624134", "Lamp": "03636649", "Laptop": "03642806",
    "Motorbike": "03790512", "Mug": "03797390", "Pistol": "03948459", "Rocket": "04099429",
    "Skateboard": "04225987", "Table": "04379243",
}
# phase 32: the ScanNet PT-v2m2 config (48-512 channels, depths 2/2/6/2, k
# 16, AdamW + OneCycle, drop path 0.3) as written in model and recipe, at
# phase 14's cuts (batch 2, 262,144 rows, one 4-step epoch and one
# evaluation) on phase 10's scenes; its test section on one val scene of
# PTV2_TEST_POINTS raw points (52 fragments; 123 at 51,200 took 18-33 s),
# one forward a fragment at PTV2_TEST_CAPACITY rows: a fragment holds up
# to 12,264 points, nearly one a 6 cm cell in that sparse scene, so the
# first pooling's half of the rows must exceed that (at 16,384 rows it
# dropped 8.8% of the points)
PTV2_CONFIG = "configs/scannet/semseg-pt-v2m2-0-base.py"
PTV2_TEST_POINTS = 12800
PTV2_TEST_CAPACITY = 32768
# phase 33: PT-v2m2 and PT-v2m1 (the grouped linear with the position
# multiplier) at one block a stage, f32, on the card against the CPU, on a
# scene of PTV2_SCENE (points, extent in m): its stages hold 2,908 / 758 /
# 122 / 17 clusters, nothing dropped, the deepest more than k = 16 (at
# 4,096 points of 1.2 m it held 5, whose repeated neighbour slots made its
# position norm's gradient move by ~0.5 under a 1e-6 nudge on the CPU
# alone); the config's recipe, drop path 0
PTV2_SCENE = (6144, 5.4)
PTV2_SMALL = dict(type="PT-v2m2", in_channels=6, num_classes=NUM_CLASSES, enc_depths=(1, 1, 1, 1),
                  dec_depths=(1, 1, 1, 1), grid_sizes=(0.06, 0.15, 0.375, 0.9375),
                  pool_capacity_factors=(0.5, 0.35, 0.3, 0.3))
PTV2_RECIPE = dict(optimizer=dict(type="AdamW", lr=0.005, weight_decay=0.02), param_dicts=None,
                   scheduler=dict(type="OneCycleLR", max_lr=0.005, pct_start=0.05, anneal_strategy="cos",
                                  div_factor=10.0, final_div_factor=1000.0))
# phase 34: the Context-Aware Classifier over SpUNet (4 steps) and over
# PT-v2m2 (one epoch of 2 steps and its evaluation) at phase 14's cuts
CAC_CONFIGS = (("cac_spunet", "configs/scannet/semseg-cac-v1m1-0-spunet-base.py", {}),
               ("cac_ptv2", "configs/scannet/semseg-cac-v1m1-2-ptv2-lovasz.py", dict(epoch=1, eval_epoch=1)))
CAC_LOSSES = ("seg_loss", "pre_loss", "pre_self_loss", "kl_loss")
# phase 35: PT-v3m1's relative position encoding through the S3DIS RPE
# config (PT-v3m1-base at patch 128, a [93, H] table a block, the block
# engine) on phase 17's offices at phase 14's cuts: batch 2 in 262,144 rows
# (two of SphereCrop's 204,800-point rooms, subsampled by the loader),
# 4 steps, one evaluation; the first pooling at 0.65 (at the config's 0.5 a
# pair of rooms held up to ~146,000 clusters against its 131,072) and the
# val capacity from the Area_5 room's 2 cm voxels (~364,000)
RPE_CONFIG = "configs/s3dis/semseg-pt-v3m1-1-rpe.py"
RPE_POOL = (0.65, 0.5, 0.5, 0.5)
RPE_OPTIONS = dict(S3DIS_OPTIONS, **{"model.backbone.pool_capacity_factors": RPE_POOL})
RPE_KERNELS = ("patch_attention_rpe", "patch_attention_rpe_bwd", "block_fill", "take_back")
# the biased kernels' shapes: its stage 0 (C 32, H 2) and stage 4 (C 512,
# H 32) over a step's 262,144 rows at patch 128, (stage, C, H, launches a
# step, forward and backward)
RPE_ATTENTION = ((0, 32, 2, 2), (4, 512, 32, 2))
# phases 36-37: LitePT-v1 through the ScanNet LitePT config's data, transforms,
# AdamW + OneCycle, loss and `block` lr group, its backbone at the class
# defaults (widths 36-504, heads 2-28: head dim 18 at every stage; the
# config's patch_size and head dim 16 run in neither package) at the
# config's input width and depth, and the default decoder's 72 channels for
# the head; on phase 10's scenes at phase 14's cuts; its test section on one
# val scene of LITEPT_TEST_POINTS raw points at PT-v2's 32,768 rows a fragment
LITEPT_CONFIG = "configs/scannet/semseg-litept-v1m1-0-small.py"
LITEPT_OPTIONS = {"model.backbone": dict(_delete_=True, type="LitePT-v1", in_channels=6, serialize_depth=11),
                  "model.backbone_out_channels": 72}
LITEPT_POOL = (0.5, 0.5, 0.5, 0.5)
# its attention stages 3 (C 252, H 14, 6 blocks) and 4 (C 504, H 28, 2
# blocks) at K 1024, D 18 on heads padded to 24, (stage, C, H, launches a step)
LITEPT_ATTENTION = ((3, 252, 14, 6), (4, 504, 28, 2))
LITEPT_TEST_POINTS = 12800
LITEPT_TEST_CAPACITY = 32768
# phase 38: card against CPU (f32, one block a stage) of LitePT at the class
# widths and of PT-v3m1 with RPE at patch 128, on a scene of (points, extent
# in m) as phases 8 and 26's, every pooling at factor 1.0 (at 0.5 LitePT's
# first drops ~1,200 of its points), PT-v3 on the gather engine (its block
# tables at 1/8 drop ~2,300 points there; phases 6 and 8 hold the block
# engine against the CPU)
LITEPT_SMALL = dict(type="LitePT-v1", in_channels=6, enc_depths=(1,) * 5, drop_path=0.0, serialize_depth=11,
                    pool_capacity_factors=(1.0,) * 4)
SMALL_SCENE = (4096, 1.2)
# card-vs-CPU bounds of one train step (tests/test_torch_port_train.py):
# loss relative error, per-tensor gradient relative L2 error, cosine; the
# gradient bounds widen to twice the run's own noise floor (phase 8)
TRAIN_BOUNDS = {False: (2e-2, 5e-2, 0.999), True: (1e-1, 1.5e-1, 0.99)}


_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``t``: seconds since the script started."""
    print(json.dumps({"phase": phase, **kw, "t": time.perf_counter() - _START}), flush=True)


# The card-vs-CPU phases hold the port on the card against its plain
# versions on the CPU. Their CPU sides need nothing the card computes, so one
# spawned worker process computes them ahead, beside the card's phases: main()
# submits every such job whose inputs exist at the start, in phase order (a
# phase that writes its inputs submits its own), and each phase computes its
# card side, then waits for its CPU side. The checks, sizes and bounds are the
# same as when the CPU side ran inline.
_CPU = {"pool": None, "jobs": {}}
CPU_JOB_TIMEOUT = 900


def _cpu_worker_init(root: str, threads: int) -> None:
    sys.path.insert(0, root)
    import torch

    torch.set_num_threads(threads)


def start_cpu_worker(threads: int) -> None:
    import multiprocessing

    _CPU["pool"] = multiprocessing.get_context("spawn").Pool(1, initializer=_cpu_worker_init,
                                                             initargs=(ROOT, threads))


def stop_cpu_worker(finished: bool) -> None:
    """Close the worker (after its jobs when `finished`, at once else) and wait for it."""
    pool = _CPU["pool"]
    if pool is not None:
        if finished:
            pool.close()
        else:
            pool.terminate()
        pool.join()
    _CPU.update(pool=None, jobs={})


def cpu_prefetch(jobs) -> None:
    """Queue CPU-worker jobs (key, function, arguments) ahead of their phases."""
    for key, fn, args in jobs:
        if _CPU["pool"] is not None and key not in _CPU["jobs"]:
            _CPU["jobs"][key] = _CPU["pool"].apply_async(fn, args)


def cpu_result(key: str, fn, args):
    """A job's result: the queued one, or queued now; in this process when
    no worker runs (a phase driven alone)."""
    job = _CPU["jobs"].pop(key, None)
    if job is None:
        if _CPU["pool"] is None:
            return fn(*args)
        job = _CPU["pool"].apply_async(fn, args)
    return job.get(timeout=CPU_JOB_TIMEOUT)


# the card-vs-CPU arguments of phases 8 and 9 (SpUNet's)
PHASE8_CVCT = dict(capacity=4096, extent=1.2)
SPUNET_CVC = dict(cases=[(False, dict(SPUNET_MODEL, backbone=SPUNET_SMALL))], phase="spunet_card_vs_cpu")
# at a quarter of the scene (4,096 points, 1.2 m): its CPU steps took 112 s of the time limit at
# 16,384 and 27-62 s at 8,192
SPUNET_CVCT = dict(cases=[(False, dict(SPUNET_MODEL, backbone=SPUNET_SMALL), SPUNET_RECIPE)],
                   phase="spunet_card_vs_cpu_train", capacity=4096, extent=1.2)


def static_cpu_jobs() -> list:
    """The CPU-worker jobs of every card-vs-CPU phase whose inputs exist at
    the start, in phase order (phase 29's waits for its clouds)."""
    jobs = card_vs_cpu_jobs() + card_vs_cpu_train_jobs(**PHASE8_CVCT)
    jobs += card_vs_cpu_jobs(**SPUNET_CVC) + card_vs_cpu_train_jobs(**SPUNET_CVCT) + [SONATA_CPU_JOB]
    for kw in (utonia_cvct(), lora_cvct(), ppt_cvct(), insseg_cvct()):
        jobs += card_vs_cpu_train_jobs(**kw)
    for logits, train in ptv2_cvc() + small_cvc():
        jobs += card_vs_cpu_jobs(**logits) + card_vs_cpu_train_jobs(**train)
    return jobs


def _phase_runner():
    """`phase(label, fn, *args, **kw)` runs one phase, prints its own
    seconds (the `t` stamps of `emit` are cumulative) and keeps them in
    ``phase.seconds``."""
    seconds = {}

    def phase(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[label] = time.perf_counter() - t0
        emit("phase_seconds", of=label, seconds=seconds[label])
        return out

    phase.seconds = seconds
    return phase


def release() -> None:
    """Give the card back what the last phase left. A trainer and its hooks
    reference each other, so `del trainer` frees nothing until the cycle
    collector happens to run: collect first, then empty the cache."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def scene(seed, capacity: int = CAPACITY, extent: float = 6.0, labelled: bool = False):
    """Collated ScanNet-like synthetic scenes at 0.02 m (numpy): the
    repository's benchmark scene (a 6 m room, 4x oversampled, center-cropped
    to `capacity` points), one per seed (`seed` an int or a tuple of seeds),
    labels dropped unless `labelled`. Made once for each set of arguments
    (PTv3's and SpUNet's phases read the same scenes): callers copy before
    they change one."""
    from pointcept_tpu_torch.datasets import scene_batch

    seeds = (seed,) if isinstance(seed, int) else tuple(seed)
    arrays = scene_batch(seeds, points_per_scene=capacity, num_classes=20, extent=extent)
    arrays.pop("num_scenes")
    if not labelled:
        arrays.pop("segment")
    return arrays


def time_ms(fn, samples: int = 7, reps: int = 5, hold: int = 0) -> float:
    """Median over `samples` of the CUDA-event time of `reps` calls, per call.
    With `hold` the stream first spins that many clock cycles, so that the
    host queues the `reps` calls ahead and the events time the device alone."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(hold)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def paired_ms(fn, library, rounds: int = 3, hold: int = 10_000_000) -> dict:
    """A kernel and the library call it is compared with, timed in turns:
    `rounds` readings of each (`time_ms`), kernel then library, each behind
    a hold of the stream (~5 ms), so that neither reading waits on the host
    (autograd's backward takes longer to queue than SDPA's small backward
    kernels take to run). Returns their medians (`ms`, `library_ms`) and
    ranges over the rounds."""
    ks, ls = [], []
    for _ in range(rounds):
        ks.append(time_ms(fn, hold=hold))
        ls.append(time_ms(library, hold=hold))
    return dict(ms=statistics.median(ks), ms_range=[min(ks), max(ks)], library_ms=statistics.median(ls),
                library_ms_range=[min(ls), max(ls)])


def stage0_tables(arrays, device):
    """Serialize a scene, pin it to z-order and build the stage-0 block tables
    exactly as the model does."""
    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.ops.block_conv import build_block_tables, default_block_capacity

    pb = make_point_batch(arrays, 1, device=device)
    pb = pb.serialize(BACKBONE["order"], BACKBONE["serialize_depth"], sort_indices=(0,), key_orders=(0,))
    pb = pb.reorder(pb.serialized_order[0], pb.serialized_inverse[0], rebase_orders=(0,), rebase_keys=(0,))
    m = default_block_capacity(pb.capacity, BACKBONE["block_capacity_factor"][0])
    t = build_block_tables(pb.serialized_keys[0], pb.serialized_order[0], pb.grid_coord, pb.mask,
                           pb.serialized_depth, m, block_bits=BACKBONE["block_bits"],
                           inverse0=pb.serialized_inverse[0], identity_order0=True)
    return pb, t


def check_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    emit("check", kernel=name, shape=list(got.shape), max_abs_err=max_abs, atol=atol, rtol=rtol, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs err {max_abs})")
    return max_abs


def _named(row: dict) -> dict:
    return {("kernel_ms" if k == "ms" else k): v for k, v in row.items()}


def _patches(capacity: int, stage: int, num_scenes: int, factors=BACKBONE["pool_capacity_factors"],
             k: int = 1024) -> int:
    """Patches of one stage: the model's static pooled capacity, padded."""
    cap = capacity
    for f in factors[:stage]:
        cap = -(-max(math.ceil(cap * f), 128) // 128) * 128
    return -(-cap // k) + num_scenes  # padded_capacity / K


def kernel_cases(device, arrays):
    """Phase 3 and 4: every kernel against its plain version, then timed.
    Returns {kernel: dict of the numbers of its main-path case}."""
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    exp_rate = EXP_PER_CLOCK_PER_SM * sms * clock_hz
    results = {}

    # A. attention, forward and backward (D in the function below), with
    # and without the RPE bias
    results.update(attention_cases(device, gen, exp_rate))
    results.update(rpe_attention_cases(device, gen, exp_rate))
    pb, t = stage0_tables(arrays, device)

    # B. block fill at the stem (Cin=6) and the first convs (Cin=32), and
    # C. the take-back of a conv output (Cout=32): PTv3's stage-0 tables (4^3
    # blocks) and SpUNet's level-0 tables (8^3 blocks) of the real scene;
    # D. both at the tester's stage 0 (8^3 blocks), its encoder's and
    # decoder's widths
    levels = spunet_geometry(arrays, device)
    rows = fill_take_back_cases(device, gen, "PTv3", t, (6, 32), (32,), stem=pb.feat)
    results["block_fill"], results["take_back"] = rows[("block_fill", 32)], rows[("take_back", 32)]
    fill_take_back_cases(device, gen, "SpUNet", levels[0]["nbr"], (6, 32), (32,), stem=pb.feat)
    fill_take_back_cases(device, gen, "tester", tester_stage0_tables(device)[1], (32, 64), (32, 64))

    # E. the fill and the take-back as each other's VJP, in the sorted route
    # (the eval forward's tables), the shuffled one (tables re-sorted by z)
    # and SpUNet's (8^3 blocks)
    vjp_cases(device, arrays, gen, levels[0]["nbr"])

    # F. the fused block conv, G. the gather conv's VJP
    results.update(tap_conv_cases(device, t, levels, gen))
    gather_vjp_case(device, spunet_geometry(arrays, device, backbone=dict(SPUNET, conv_engine="gather"))[1]["nbr"],
                    gen)
    return results


def fill_take_back_cases(device, gen, model, tables, cins, couts, stem=None):
    """`block_fill` (at each width of `cins`; 6 fills `stem`, the scene's
    features) and `take_back_rows` (at each width of `couts`) on `tables`
    against their plain versions, exactly, then timed beside their library
    calls. Returns the rows by (kernel, width)."""
    import torch

    from pointcept_tpu_torch.ops.kernels import block_fill, block_fill_plain, take_back_rows, take_back_rows_plain

    b3 = 1 << (3 * tables["block_bits"])
    rc, starts, slot = tables["rc_sorted"], tables["fill_start"], tables["slot"]
    n, m = rc.shape[0], starts.shape[0]
    ok = rc >= 0
    nvalid = int(ok.sum())
    rows = {}
    for cin in cins:
        feat = stem if cin == 6 else torch.randn((n, cin), generator=gen, device=device)
        feat = feat.to(torch.bfloat16).contiguous()
        got = block_fill(feat, rc, starts, b3)
        want = block_fill_plain(feat, rc, starts, b3)
        torch.cuda.synchronize()
        err = check_close(f"block_fill[{model},b3={b3},Cin={cin}]", got, want, atol=0.0, rtol=0.0)
        del got, want
        idx, vals = rc[ok].long(), feat[ok]
        row = dict(
            shape=dict(model=model, N=n, valid=nvalid, m=m, b3=b3, Cin=cin), max_abs_err=err,
            ms=time_ms(lambda: block_fill(feat, rc, starts, b3)),
            plain_ms=time_ms(lambda: block_fill_plain(feat, rc, starts, b3)),
            library_ms=time_ms(lambda: torch.zeros(((m + 1) * b3, cin), dtype=feat.dtype,
                                                   device=device).index_put_((idx,), vals)),
        )
        bytes_ = nvalid * cin * 2 + n * 4 + m * 4 + (m + 1) * b3 * cin * 2
        row["bound_ms"] = bytes_ / PEAK_BYTES * 1e3
        row["bound_by"] = "bytes"
        emit("time", kernel="block_fill", library="zeros + index_put_", **_named(row))
        rows[("block_fill", cin)] = row
    for c in couts:
        dense = torch.randn(((m + 1) * b3, c), generator=gen, device=device).to(torch.bfloat16)
        got = take_back_rows(dense, slot)
        want = take_back_rows_plain(dense, slot)
        torch.cuda.synchronize()
        err = check_close(f"take_back_rows[{model},b3={b3},C={c}]", got, want, atol=0.0, rtol=0.0)
        del got, want
        slot_l = slot.long()
        row = dict(
            shape=dict(model=model, N=n, R=dense.shape[0], C=c), max_abs_err=err,
            ms=time_ms(lambda: take_back_rows(dense, slot)),
            plain_ms=time_ms(lambda: take_back_rows_plain(dense, slot)),
            library_ms=time_ms(lambda: torch.index_select(dense, 0, slot_l)),
        )
        row["bound_ms"] = (n * c * 2 * 2 + n * 4) / PEAK_BYTES * 1e3
        row["bound_by"] = "bytes"
        emit("time", kernel="take_back", library="torch.index_select", **_named(row))
        rows[("take_back", c)] = row
        del dense
    return rows


def tester_grid():
    """The voxel grid of val scene 5 at the config's 0.02 m: every voxel of
    the raw scene once, as each of its test fragments holds it."""
    import numpy as np

    from pointcept_tpu_torch.datasets import synthesize_scene

    coord = synthesize_scene(int(TESTER_SCENE[5:9]), num_points=RAW_POINTS, num_classes=NUM_CLASSES,
                             extent=6.0)["coord"]
    grid = np.floor(coord / 0.02).astype(np.int64)
    return np.unique(grid - grid.min(0), axis=0).astype(np.int32)


def tester_stage0_tables(device):
    """The tester's stage 0 as the ScanNet config builds it: TESTER_B copies
    of `tester_grid` in slots of `point_capacity_test` rows, serialized at
    the config's depth 11, pinned to z-order, 8^3 block tables at 1/32."""
    import torch

    from pointcept_tpu_torch.models.utils.structure import PointBatch
    from pointcept_tpu_torch.ops.block_conv import build_block_tables, default_block_capacity

    grid = torch.as_tensor(tester_grid(), device=device)
    cap, n = TESTER_OPTIONS["point_capacity_test"], grid.shape[0]
    grid_b = torch.zeros((TESTER_B * cap, 3), dtype=torch.int32, device=device)
    batch_b = torch.full((TESTER_B * cap,), -1, dtype=torch.int32, device=device)
    for s in range(TESTER_B):
        grid_b[s * cap : s * cap + n] = grid
        batch_b[s * cap : s * cap + n] = s
    pb = PointBatch(coord=grid_b.float() * 0.02, feat=None, grid_coord=grid_b, batch=batch_b, num_scenes=TESTER_B)
    pb = pb.serialize(("z",), 11, sort_indices=(0,), key_orders=(0,))
    pb = pb.reorder(pb.serialized_order[0], pb.serialized_inverse[0], rebase_orders=(0,), rebase_keys=(0,))
    t = build_block_tables(pb.serialized_keys[0], pb.serialized_order[0], pb.grid_coord, pb.mask,
                           pb.serialized_depth, default_block_capacity(pb.capacity, 1 / 32), block_bits=3,
                           inverse0=pb.serialized_inverse[0], identity_order0=True)
    if int(t["overflow"]):
        raise AssertionError(f"the tester's stage-0 tables overflow: {int(t['overflow'])}")
    return pb, t


def attention_shapes():
    """The attention calls of one PTv3-base forward: per stage, each (C, H)
    of its encoder and decoder blocks with its launches (every block
    attends once; the train step's backward launches as many)."""
    b = BACKBONE
    rows = []
    for stage in range(5):
        shapes = {}
        widths = [(b["enc_channels"][stage], b["enc_num_head"][stage], b["enc_depths"][stage])]
        if stage < len(b["dec_depths"]):
            widths.append((b["dec_channels"][stage], b["dec_num_head"][stage], b["dec_depths"][stage]))
        for c, h, n in widths:
            shapes[(c, h)] = shapes.get((c, h), 0) + n
        rows += [(stage, c, h, n) for (c, h), n in shapes.items()]
    return rows


def attention_cases(device, gen, exp_rate):
    """The attention kernels against their plain versions and timed at every
    shape of the two main paths: the eval forward (one scene, `stats` off)
    and the train step (two scenes: the forward with its row statistics and
    the backward), each timed in turns with SDPA (its forward with no
    autograd graph, as the kernel runs, or the backward of its graph) and
    beside its bound, with its launches per forward or step (from the
    config's depths);
    then the backward at patch 128 (the TPU's whole-K kernels, which only
    K <= 512 reaches; no main-path launch). The forward (output and
    statistics) and the backward must give the same bits twice at the
    stage-0 train shape. Returns the rows of the kernels line: the eval
    forward and the train backward at stage 0's encoder width, and Utonia's
    stage 0 at head dim 18 and the tiny classifier's stage 0 at head dim 4
    (forward and backward)."""
    import torch
    import torch.nn.functional as F

    from pointcept_tpu_torch.ops.kernels import (
        patch_attention_bwd, patch_attention_bwd_plain, patch_attention_fwd, patch_attention_fwd_plain,
    )

    k = 1024
    results, sums = {}, {}
    cases = [("eval", 1, stage, c, h, n) for stage, c, h, n in attention_shapes()]
    cases += [("train", 2, stage, c, h, n) for stage, c, h, n in attention_shapes()]
    cases += [("patch 128", 2, None, c, h, 0) for c, h in ((32, 2), (256, 16))]
    o = OVERFIT_ATTENTION
    cases += [("overfit train", o["scenes"], "D=8", o["c"], o["h"], o["launches"])]
    # Sonata's global views (two scenes, two views each): its stage 0 and
    # its 12-block stage 3, launches of the teacher's and both student
    # forwards, and of both student backwards
    cases += [("sonata", 2 * SONATA_VIEWS[0], stage, c, h, n) for stage, c, h, n in SONATA_ATTENTION]
    # the tester's stage 0 (TESTER_B fragments a forward), encoder and decoder
    cases += [("tester", TESTER_B, stage, c, h, n) for stage, c, h, n in attention_shapes() if stage == 0]
    # Utonia's head dim 18 (two scenes a fine-tune step), launches of a step's
    # forward and backward
    cases += [("utonia", 2, stage, c, h, n) for stage, c, h, n in UTONIA_ATTENTION]
    # Concerto-large's LoRA fine-tune (two scenes a step), forward and backward
    cases += [("lora", 2, stage, c, h, n) for stage, c, h, n in LORA_ATTENTION]
    # the outdoor configs (two scans a step), forward and backward
    cases += [(path, 2, stage, c, h, n) for path, stage, c, h, n in OUTDOOR_ATTENTION]
    # PPT-extreme (two scenes a step), forward and backward
    cases += [("ppt", 2, stage, c, h, n) for stage, c, h, n in PPT_ATTENTION]
    # ModelNet40's classifier (32 clouds a step): stages 0 and 4, forward and backward
    cases += [("modelnet", CLS_SCENES, stage, c, h, n) for stage, c, h, n in CLS_ATTENTION]
    # the tiny classifier's head dim 4 at patch 64 (8 clouds a step), zero-padded to 16
    cases += [("cls tiny", 8, stage, c, h, n) for stage, c, h, n in CLS_TINY_ATTENTION]
    # LitePT's attention stages at head dim 18 (two scenes a step), forward and backward
    cases += [("litept", 2, stage, c, h, n) for stage, c, h, n in LITEPT_ATTENTION]
    tiny_pool = CLS_TINY_OPTIONS["model.backbone.pool_capacity_factors"]
    for path, scenes, stage, c, h, launches in cases:
        kk_ = 64 if path == "cls tiny" else k if isinstance(stage, int) else 128
        np_ = (-(-scenes * TESTER_OPTIONS["point_capacity_test"] // k) + scenes if path == "tester"
               else _patches(CLS_CAPACITY, stage, scenes, CLS_OPTIONS["model.backbone.pool_capacity_factors"])
               if path == "modelnet"
               else _patches(2048, stage, scenes, tiny_pool, k=64) if path == "cls tiny"
               else _patches(SONATA_OPTIONS["point_capacity"], stage, scenes, SONATA_POOL) if path == "sonata"
               else _patches(DOWNSTREAM_OPTIONS["point_capacity"], stage, scenes, UTONIA_POOL) if path == "utonia"
               else _patches(DOWNSTREAM_OPTIONS["point_capacity"], stage, scenes, LORA_POOL) if path == "lora"
               else _patches(PPT_OPTIONS["point_capacity"], stage, scenes, PPT_POOL) if path == "ppt"
               else _patches(DOWNSTREAM_OPTIONS["point_capacity"], stage, scenes, LITEPT_POOL) if path == "litept"
               else _patches(OUTDOOR_CAPACITY[path], stage, scenes, OUTDOOR_ATTENTION_POOL[path])
               if path in OUTDOOR_ATTENTION_POOL
               else _patches(scenes * CAPACITY, stage, scenes) if isinstance(stage, int)
               else o["capacity"] // o["k"] + scenes if stage == "D=8" else scenes * CAPACITY // 128 + 2)
        d = c // h
        scale = d**-0.5
        shape = dict(path=path, stage=stage, nP=np_, K=kk_, C=c, H=h, pairs=np_ * h)
        label = f"{path},stage={stage},C={c},K={kk_}"
        qkv = torch.randn((np_, kk_, 3 * c), generator=gen, device=device).to(torch.bfloat16)
        q, kk, v = (qkv.view(np_, kk_, 3, h, d)[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        serving = path in ("eval", "tester")
        per = "launches_per_forward" if serving else "launches_per_step"
        kernels = ("fwd",) if serving else ("fwd", "bwd") if stage is not None else ("bwd",)
        # a Sonata step: every block attends in three forwards and two backwards
        launches_of = {"fwd": launches, "bwd": launches * 2 // 3} if path == "sonata" else None
        stats = not serving
        # every shape is checked; the shapes of earlier slices' paths are timed in the runs
        # that brought them (PERF.md §6) and no more, for the time limit
        timed = path in TIMED_PATHS or (stage == 0 and path in ("utonia", "cls tiny"))
        out, m_, l_ = patch_attention_fwd(qkv, h, scale, stats=True)
        for kern in kernels:
            if kern == "fwd":
                got = patch_attention_fwd(qkv, h, scale, stats=stats)
                want = patch_attention_fwd_plain(qkv, h, scale, stats=stats)
                torch.cuda.synchronize()
                # bf16 output rounding (one ulp is 2^-8 relative) plus exp and summation order
                err = check_close(f"patch_attention[{label}]", got[0] if stats else got,
                                  want[0] if stats else want, atol=2e-2, rtol=2e-2)
                if not timed:
                    continue
                # SDPA's forward as the kernel runs: no autograd graph recorded
                with torch.no_grad():
                    row = paired_ms(lambda: patch_attention_fwd(qkv, h, scale, stats=stats),
                                    lambda: F.scaled_dot_product_attention(q, kk, v, scale=scale))
                row.update(shape=shape, max_abs_err=err,
                           plain_ms=time_ms(lambda: patch_attention_fwd_plain(qkv, h, scale, stats=stats),
                                            samples=3, reps=1))
                bytes_ = np_ * kk_ * 4 * c * 2 + (np_ * h * kk_ * 8 if stats else 0)
                flops = 4 * np_ * h * kk_ * kk_ * d
                name, library = "patch_attention", "F.scaled_dot_product_attention"
            else:
                dout = torch.randn((np_, kk_, c), generator=gen, device=device).to(torch.bfloat16)
                got = patch_attention_bwd(qkv, out, dout, m_, l_, h, scale)
                want = patch_attention_bwd_plain(qkv, out, dout, m_, l_, h, scale)
                torch.cuda.synchronize()
                # bf16 outputs (one ulp 2^-8 relative), p and dS rounded to bf16 after
                # exps and sums taken in another order: bounded against the largest
                # gradient, as tests/test_torch_port_kernels.py
                err = check_close(f"patch_attention_bwd[{label}]", got, want,
                                  atol=2e-2 * float(want.float().abs().max()), rtol=2e-2)
                if ((path == "train" and stage == 0 and c == BACKBONE["enc_channels"][0]) or stage == "D=8"
                        or (path in ("sonata", "utonia", "lora", "modelnet", "cls tiny") and stage == 0)):
                    identical_checks(qkv, out, dout, m_, l_, h, scale, got)
                if not timed:
                    continue
                leaves = [x.detach().requires_grad_() for x in (q, kk, v)]
                sdpa = F.scaled_dot_product_attention(*leaves, scale=scale)
                do4 = dout.view(np_, kk_, h, d).transpose(1, 2).contiguous()
                row = paired_ms(lambda: patch_attention_bwd(qkv, out, dout, m_, l_, h, scale),
                                lambda: torch.autograd.grad(sdpa, leaves, do4, retain_graph=True))
                row.update(shape=shape, max_abs_err=err,
                           plain_ms=time_ms(lambda: patch_attention_bwd_plain(qkv, out, dout, m_, l_, h, scale),
                                            samples=3, reps=1))
                # qkv, out, dout, m and l read once, dqkv written once
                bytes_ = np_ * kk_ * (3 * c * 2 + c * 2 + c * 2 + 3 * c * 2) + np_ * h * kk_ * 8
                flops = 10 * np_ * h * kk_ * kk_ * d  # 5 products of 2*D flops per score
                name, library = "patch_attention_bwd", "backward of F.scaled_dot_product_attention"
            exps = np_ * h * kk_ * kk_
            row["bound_ms"] = max(bytes_ / PEAK_BYTES, exps / exp_rate, flops / PEAK_BF16) * 1e3
            row["bound_by"] = "bytes" if bytes_ / PEAK_BYTES >= exps / exp_rate else "operations"
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["vs_library"] = row["ms"] / row["library_ms"]
            row[per] = launches if launches_of is None else launches_of[kern]
            emit("time", kernel=name, library=library, **_named(row))
            if row[per]:
                sums[(path, name)] = sums.get((path, name), 0.0) + row[per] * row["ms"]
            if stage == 0 and c == BACKBONE["enc_channels"][0] and (path, kern) in (("eval", "fwd"),
                                                                                   ("train", "bwd")):
                results[name] = row
            if path == "utonia" and stage == 0:
                results[f"{name}[D=18]"] = row
            if path == "cls tiny" and stage == 0:
                results[f"{name}[D=4]"] = row
            del got, want
    for (path, name), ms in sums.items():
        emit("attention_sum", path=path, kernel=name, ms_per_forward_or_step=ms,
             note="sum of launches (from the config) x kernel ms over the shapes above (L2-warm, back to back)")
    return results


def rpe_attention_cases(device, gen, exp_rate):
    """The biased (RPE) kernels against their plain versions at the S3DIS
    RPE config's stages 0 and 4 (a step's 262,144 rows at patch 128): the
    forward (output and statistics) and the backward (dq dk dv, and the
    table's gradient), each run twice and bit-identical; the peak memory of
    a forward and backward (their outputs and scratch) under half of one
    [nP, H, K, K] f32 bias, which the kernels never build; each timed in turns with SDPA given the bias as a
    bf16 float mask (materialised before the timing, not timed), beside
    its bound and plain version. Returns the rows of the kernels line
    (stage 0)."""
    import torch
    import torch.nn.functional as F

    from pointcept_tpu_torch.ops.kernels import patch_attention_bwd_plain, patch_attention_fwd_plain
    from pointcept_tpu_torch.ops.kernels import patch_attention_rpe_bwd as rpe_bwd
    from pointcept_tpu_torch.ops.kernels import patch_attention_rpe_fwd as rpe_fwd
    from pointcept_tpu_torch.ops.kernels.patch_attention import rpe_bound, rpe_lookup

    k = 128
    b = rpe_bound(k)
    results = {}
    for stage, c, h, launches in RPE_ATTENTION:
        np_ = _patches(RPE_OPTIONS["point_capacity"], stage, 2, RPE_POOL, k=k)
        d = c // h
        scale = d**-0.5
        shape = dict(path="rpe", stage=stage, nP=np_, K=k, C=c, H=h, pairs=np_ * h, bound=b)
        label = f"rpe,stage={stage},C={c},K={k}"
        qkv = torch.randn((np_, k, 3 * c), generator=gen, device=device).to(torch.bfloat16)
        table = torch.randn((3 * (2 * b + 1), h), generator=gen, device=device) * 0.5
        # grid coordinates in a box of 3b + 1 cells: some differences clip
        coords = torch.randint(0, 3 * b + 1, (np_, k, 3), generator=gen, device=device, dtype=torch.int32)
        dout = torch.randn((np_, k, c), generator=gen, device=device).to(torch.bfloat16)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out, m_, l_ = rpe_fwd(qkv, h, scale, table, coords, stats=True)
        dqkv, dtab = rpe_bwd(qkv, out, dout, m_, l_, h, scale, table, coords)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(device) - base
        dense = np_ * h * k * k * 4
        emit("check", kernel=f"patch_attention_rpe memory[{label}]", peak_extra_bytes=extra,
             dense_bias_bytes=dense, ok=extra < dense // 2)
        if extra >= dense // 2:
            raise AssertionError(f"rpe attention: {extra} bytes beside a dense bias of {dense}")
        want = patch_attention_fwd_plain(qkv, h, scale, stats=True, rpe=(table, coords))
        err_f = check_close(f"patch_attention_rpe[{label}]", out, want[0], atol=2e-2, rtol=2e-2)
        check_close(f"patch_attention_rpe m[{label}]", m_, want[1], atol=1e-4, rtol=1e-4)
        check_close(f"patch_attention_rpe l[{label}]", l_, want[2], atol=1e-3, rtol=1e-3)
        wq, wt = patch_attention_bwd_plain(qkv, out, dout, m_, l_, h, scale, rpe=(table, coords))
        err_b = check_close(f"patch_attention_rpe_bwd[{label}]", dqkv, wq,
                            atol=2e-2 * float(wq.float().abs().max()), rtol=2e-2)
        # f32 sums of the unrounded dS' in two orders, p from ex2.approx
        check_close(f"patch_attention_rpe_bwd table[{label}]", dtab, wt, atol=1e-3 * float(wt.abs().max()),
                    rtol=1e-2)
        again = rpe_fwd(qkv, h, scale, table, coords, stats=True)
        fwd_same = all(torch.equal(x, y) for x, y in zip((out, m_, l_), again))
        bwd_again = rpe_bwd(qkv, out, dout, m_, l_, h, scale, table, coords)
        bwd_same = torch.equal(dqkv, bwd_again[0]) and torch.equal(dtab, bwd_again[1])
        torch.cuda.synchronize()
        for name, same in (("patch_attention_rpe (out, m, l)", fwd_same),
                           ("patch_attention_rpe_bwd (dqkv, table)", bwd_same)):
            emit("check", kernel=f"{name} twice[{label}]", bit_identical=same, ok=same)
            if not same:
                raise AssertionError(f"{name}: two runs on the same inputs differ ({label})")
        del want, wq, wt, again, bwd_again
        mask = rpe_lookup(table, coords).to(torch.bfloat16)  # [nP, H, K, K]
        q, kk, v = (qkv.view(np_, k, 3, h, d)[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        exps = np_ * h * k * k
        for kern in ("fwd", "bwd"):
            if kern == "fwd":
                with torch.no_grad():
                    row = paired_ms(lambda: rpe_fwd(qkv, h, scale, table, coords, stats=True),
                                    lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=mask, scale=scale))
                row.update(shape=shape, max_abs_err=err_f, plain_ms=time_ms(
                    lambda: patch_attention_fwd_plain(qkv, h, scale, stats=True, rpe=(table, coords)),
                    samples=3, reps=1))
                # qkv, the coordinates and the table read once; out, m and l written once
                bytes_ = np_ * k * 4 * c * 2 + np_ * h * k * 8 + np_ * k * 12 + table.numel() * 4
                flops = 4 * exps * d
                name, library = "patch_attention_rpe", "F.scaled_dot_product_attention (bias as attn_mask)"
            else:
                leaves = [x.detach().requires_grad_() for x in (q, kk, v)]
                sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
                do4 = dout.view(np_, k, h, d).transpose(1, 2).contiguous()
                row = paired_ms(lambda: rpe_bwd(qkv, out, dout, m_, l_, h, scale, table, coords),
                                lambda: torch.autograd.grad(sdpa, leaves, do4, retain_graph=True))
                row.update(shape=shape, max_abs_err=err_b, plain_ms=time_ms(
                    lambda: patch_attention_bwd_plain(qkv, out, dout, m_, l_, h, scale, rpe=(table, coords)),
                    samples=3, reps=1))
                # qkv, out, dout, m, l, the coordinates and the table read once; dqkv and the table's gradient
                # written once
                bytes_ = (np_ * k * (3 * c * 2 + c * 2 + c * 2 + 3 * c * 2) + np_ * h * k * 8 + np_ * k * 12
                          + 2 * table.numel() * 4)
                flops = 10 * exps * d
                name, library = "patch_attention_rpe_bwd", "backward of F.scaled_dot_product_attention (attn_mask)"
                del leaves, sdpa
            row["bound_ms"] = max(bytes_ / PEAK_BYTES, exps / exp_rate, flops / PEAK_BF16) * 1e3
            row["bound_by"] = "bytes" if bytes_ / PEAK_BYTES >= exps / exp_rate else "operations"
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["vs_library"] = row["ms"] / row["library_ms"]
            row["launches_per_step"] = launches
            emit("time", kernel=name, library=library, **_named(row))
            if stage == 0:
                results[name] = row
        del qkv, out, dout, dqkv, dtab, mask, q, kk, v
        release()
    return results


def identical_checks(qkv, out, dout, m, l, h, scale, first_dqkv):
    """The forward (output, m and l) and the backward run again on the same
    inputs must give the same bits: no atomics, fixed summation orders."""
    import torch

    from pointcept_tpu_torch.ops.kernels import patch_attention_bwd, patch_attention_fwd

    again = patch_attention_fwd(qkv, h, scale, stats=True)
    fwd_same = all(torch.equal(a, b) for a, b in zip((out, m, l), again))
    bwd_same = torch.equal(first_dqkv, patch_attention_bwd(qkv, out, dout, m, l, h, scale))
    torch.cuda.synchronize()
    for name, same in (("patch_attention (out, m, l)", fwd_same), ("patch_attention_bwd", bwd_same)):
        emit("check", kernel=f"{name} twice", shape=list(qkv.shape), bit_identical=same, ok=same)
        if not same:
            raise AssertionError(f"{name}: two runs on the same inputs differ")


def spunet_geometry(arrays, device, num_scenes: int = 1, backbone: dict = SPUNET):
    """The SpUNet backbone's levels of a batch, as the model builds them
    (`SpUNetBase.geometry`): each level's mask and block tables or rule map."""
    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models import MODELS

    model = MODELS.build(backbone)
    pb = make_point_batch(arrays, num_scenes, device=device).with_grid_coord(model.grid_size)
    return model.geometry(pb)[0]


def tap_conv_cases(device, ptv3_tables, levels, gen):
    """`tap_conv_fwd` (forward, and the input gradient with the flipped,
    transposed weight) and `tap_conv_dw` against their plain versions on
    tiles filled from the real scene: PTv3's stage 0 and its k5 stem (4^3
    blocks), SpUNet's level 0 (a decoder conv, 128 -> 96), its k5 stem and
    level 3 (384 -> 256), 8^3 blocks. Times beside cuDNN's `conv3d` over the
    materialised halo (bf16 operands, f32 accumulation), alone and with the
    halo assembly, and cuDNN's weight gradient. Returns the rows of SpUNet's
    level 0 for the kernels line."""
    import torch
    import torch.nn.functional as F

    from pointcept_tpu_torch.ops.block_conv import BlockFill, _halo_expand
    from pointcept_tpu_torch.ops.kernels import (
        tap_conv_dw, tap_conv_dw_plain, tap_conv_fwd, tap_conv_fwd_plain,
    )
    from pointcept_tpu_torch.ops.kernels.tap_conv import occupied_tiles

    cases = [("PTv3 stage 0", ptv3_tables, 3, 32, 32), ("PTv3 stem", ptv3_tables, 5, 6, 32),
             ("SpUNet level 0", levels[0]["nbr"], 3, 128, 96), ("SpUNet stem", levels[0]["nbr"], 5, 6, 32),
             ("SpUNet level 3", levels[3]["nbr"], 3, 384, 256)]
    results = {}
    for name, t, k, cin, cout in cases:
        b = 1 << t["block_bits"]
        b3, m, n = b**3, t["nbr"].shape[0], t["slot"].shape[0]
        nbr_ext = torch.cat([t["nbr"], torch.full((1, 27), m, dtype=torch.int32, device=device)])
        with torch.no_grad():
            dense, gout = (BlockFill.apply(torch.randn((n, c), generator=gen, device=device), t,
                                           torch.bfloat16) for c in (cin, cout))
        w = (torch.randn((k**3, cin, cout), generator=gen, device=device) * (k**3 * cin) ** -0.5).to(
            torch.bfloat16)
        wt = w.flip(0).transpose(1, 2).contiguous()
        occ = int(occupied_tiles(nbr_ext).sum())
        shape = dict(case=name, N=n, b=b, m=m, occupied=occ, occupied_share=occ / m, k=k, Cin=cin, Cout=cout)
        label = f"{name},b={b},k={k},{cin}->{cout}"
        flops = 2 * occ * b3 * k**3 * cin * cout

        def bound(bytes_):
            by = "bytes" if bytes_ / PEAK_BYTES >= flops / PEAK_BF16 else "operations"
            return max(bytes_ / PEAK_BYTES, flops / PEAK_BF16) * 1e3, by

        # the library: cuDNN over the halo tiles, NCDHW views of NDHWC tensors
        h = (k - 1) // 2

        def halo(x):
            return _halo_expand(x.view(m + 1, b, b, b, x.shape[1]), nbr_ext, h).permute(0, 4, 1, 2, 3)

        for use, x, ww, ci, co in (("forward", dense, w, cin, cout), ("input_grad", gout, wt, cout, cin)):
            got = tap_conv_fwd(x, nbr_ext, ww, b, k)
            want = tap_conv_fwd_plain(x, nbr_ext, ww, b, k)
            torch.cuda.synchronize()
            scale = float(want.float().abs().max())
            if not scale > 0:
                raise AssertionError(f"tap_conv_fwd[{use},{label}]: the reference is all zero")
            # bf16 outputs (one ulp 2^-8 relative), f32 sums in another order
            err = check_close(f"tap_conv_fwd[{use},{label}]", got, want, atol=1e-2 * scale, rtol=8e-3)
            w5 = ww.reshape(k, k, k, ci, co).permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            hal = halo(x)
            row = dict(
                shape=dict(shape, use=use), max_abs_err=err,
                ms=time_ms(lambda: tap_conv_fwd(x, nbr_ext, ww, b, k)),
                plain_ms=time_ms(lambda: tap_conv_fwd_plain(x, nbr_ext, ww, b, k), samples=3, reps=1),
                library_ms=time_ms(lambda: F.conv3d(hal, w5)),
                library_with_halo_ms=time_ms(lambda: F.conv3d(halo(x), w5)),
            )
            # occupied tiles read, the table and weight read, every tile written
            row["bound_ms"], row["bound_by"] = bound(occ * b3 * ci * 2 + (m + 1) * 27 * 4
                                                     + k**3 * ci * co * 2 + (m + 1) * b3 * co * 2)
            emit("time", kernel="tap_conv_fwd", library="F.conv3d (cuDNN, bf16) over the halo", **_named(row))
            if name == "SpUNet level 0" and use == "forward":
                results["tap_conv_fwd"] = row
            del hal

        got = tap_conv_dw(dense, nbr_ext, gout, b, k)
        want = tap_conv_dw_plain(dense, nbr_ext, gout, b, k)
        again = tap_conv_dw(dense, nbr_ext, gout, b, k)
        torch.cuda.synchronize()
        rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        err = float((got - want).abs().max())
        identical = bool(torch.equal(got, again))
        ok = rel < 1e-3 and identical and got.shape == (k**3, cin, cout)
        emit("check", kernel=f"tap_conv_dw[{label}]", shape=list(got.shape), max_abs_err=err,
             rel_l2_err=rel, rel_l2_bound=1e-3, bit_identical=identical, ok=ok)
        if not ok:
            raise AssertionError(f"tap_conv_dw[{label}]: rel L2 {rel}, bit-identical {identical}")
        hal = halo(dense)
        g5 = gout.view(m + 1, b, b, b, cout).permute(0, 4, 1, 2, 3)
        w5 = w.reshape(k, k, k, cin, cout).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)

        def cudnn_dw():
            return torch.ops.aten.convolution_backward(
                g5, hal, w5, None, (1, 1, 1), (0, 0, 0), (1, 1, 1), False, (0, 0, 0), 1,
                (False, True, False))[1]

        row = dict(
            shape=shape, max_abs_err=err, rel_l2_err=rel,
            ms=time_ms(lambda: tap_conv_dw(dense, nbr_ext, gout, b, k)),
            plain_ms=time_ms(lambda: tap_conv_dw_plain(dense, nbr_ext, gout, b, k), samples=3, reps=1),
            library_ms=time_ms(cudnn_dw),
        )
        row["bound_ms"], row["bound_by"] = bound(occ * b3 * (cin + cout) * 2 + (m + 1) * 27 * 4
                                                 + k**3 * cin * cout * 4)
        emit("time", kernel="tap_conv_dw", library="cuDNN conv3d weight gradient (bf16) over the halo",
             **_named(row))
        if name == "SpUNet level 0":
            results["tap_conv_dw"] = row
        del hal
    return results


def gather_vjp_case(device, nbr, gen, c: int = 64):
    """The gather conv's VJP (`NeighborGather`, a pull) on SpUNet's level-1
    rule map (51,200 rows, each valid one read by its up to 26
    neighbours): two runs bit-identical, and within rounding of the atomic
    VJP it replaced (`TakeRows`, f32 `index_add_`)."""
    import torch

    from pointcept_tpu_torch.ops.sparse_conv import gather_conv

    n = nbr.shape[0]
    x = torch.randn((n, c), generator=gen, device=device).requires_grad_()
    w = (torch.randn((27, c, c), generator=gen, device=device) / (27 * c) ** 0.5).requires_grad_()
    cot = torch.randn((n, c), generator=gen, device=device)

    def grads(symmetric: bool):
        out = gather_conv(x, nbr, w, compute_dtype=torch.bfloat16, symmetric=symmetric)
        return torch.autograd.grad(out, (x, w), cot)

    first, second, atomic = grads(True), grads(True), grads(False)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(first, second))
    emit("check", kernel="gather_conv VJP (NeighborGather)", N=n, C=c, valid=int((nbr[:, 13] >= 0).sum()),
         reads=int((nbr >= 0).sum()), bit_identical=identical, ok=identical,
         pull_ms=time_ms(lambda: grads(True), samples=3, reps=3),
         atomic_ms=time_ms(lambda: grads(False), samples=3, reps=3))
    if not identical:
        raise AssertionError("the gather conv's VJP differs between two runs")
    scale = float(atomic[0].abs().max())
    # bf16 input gradient: the same f32 terms summed in another order, rounded once
    check_close("gather_conv VJP (pull against atomics)", first[0], atomic[0], atol=1e-2 * scale, rtol=8e-3)


def vjp_cases(device, arrays, gen, spunet_tables):
    """`BlockFill` backward (the take-back kernel, zero rows at the zero tile)
    and `TakeBack` backward (the fill kernel on the z-ordered cotangent)
    against the plain versions on the same inputs: exactly equal."""
    import torch

    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.ops.block_conv import (
        BlockFill, TakeBack, build_block_tables, default_block_capacity,
    )
    from pointcept_tpu_torch.ops.kernels import block_fill_plain, take_back_rows_plain

    _, sorted_t = stage0_tables(arrays, device)
    pb = make_point_batch(arrays, 1, device=device)
    pb = pb.serialize(BACKBONE["order"], BACKBONE["serialize_depth"])
    shuffled_t = build_block_tables(
        pb.serialized_keys[0], pb.serialized_order[0], pb.grid_coord, pb.mask, pb.serialized_depth,
        default_block_capacity(pb.capacity, BACKBONE["block_capacity_factor"][0]),
        block_bits=BACKBONE["block_bits"], inverse0=pb.serialized_inverse[0], curve_is_z=False)
    for route, t in (("sorted", sorted_t), ("shuffled", shuffled_t), ("spunet", spunet_tables)):
        b3 = 1 << (3 * t["block_bits"])
        n = t["slot"].shape[0]
        rows = (t["nbr"].shape[0] + 1) * b3
        for c in (6, 32):
            feat = torch.randn((n, c), generator=gen, device=device).to(torch.bfloat16).requires_grad_()
            g_dense = torch.randn((rows, c), generator=gen, device=device).to(torch.bfloat16)
            (got,) = torch.autograd.grad(BlockFill.apply(feat, t, torch.bfloat16), feat, g_dense)
            want = take_back_rows_plain(g_dense, t["slot"], bound=rows - b3)
            check_close(f"BlockFill.backward[{route},C={c}]", got, want, atol=0.0, rtol=0.0)
            dense = torch.zeros((rows, c), dtype=torch.bfloat16, device=device, requires_grad=True)
            g_rows = torch.randn((n, c), generator=gen, device=device).to(torch.bfloat16)
            (got,) = torch.autograd.grad(TakeBack.apply(dense, t), dense, g_rows)
            g_z = g_rows if t["identity_order0"] else g_rows[t["order0"].long()]
            want = block_fill_plain(g_z.contiguous(), t["rc_sorted"], t["fill_start"], b3)
            check_close(f"TakeBack.backward[{route},C={c}]", got, want, atol=0.0, rtol=0.0)
    torch.cuda.synchronize()


def main_path(device, card, cfg=MODEL, kernels=EVAL_KERNELS, phase="main_path"):
    """Phase 5 (and SpUNet's serving phase): the full-width eval forward,
    one scene per request (the serving path; it launches no backward
    kernel). Every overflow counter must be 0."""
    import torch

    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models import build_model
    from pointcept_tpu_torch.ops.kernels import KERNELS

    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    scenes = [scene(seed) for seed in SEEDS]
    points = [int((s["batch"] >= 0).sum()) for s in scenes]
    emit(f"{phase}_setup", capacity=CAPACITY, seeds=list(SEEDS), valid_points=points, requests=REQUESTS,
         parameters=sum(p.numel() for p in model.parameters()))

    def request(arrays):
        res = model(make_point_batch(arrays, 1, device=device))
        logits = res["seg_logits"]
        valid = torch.as_tensor(arrays["batch"] >= 0, device=device)
        overflow = [int(v) for vs in res["diagnostics"].values() for v in vs]
        finite = bool(torch.isfinite(logits[valid]).all())
        return logits, overflow, finite

    request(scenes[0])  # warm-up: kernel loads, cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    per_request = []
    checks = []
    for arrays in scenes[1:]:
        t1 = time.perf_counter()
        logits, overflow, finite = request(arrays)
        torch.cuda.synchronize()
        per_request.append((time.perf_counter() - t1) * 1e3)
        checks.append((tuple(logits.shape), overflow, finite))
    elapsed = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    emit(phase, scenes_per_s=REQUESTS / elapsed, request_ms=per_request,
         median_request_ms=statistics.median(per_request),
         peak_memory_bytes=peak, launches=launches,
         launches_per_forward={k: v / REQUESTS for k, v in launches.items()},
         logits_shapes=[c[0] for c in checks], overflow=[c[1] for c in checks],
         finite=[c[2] for c in checks], card=card)
    for shape, overflow, finite in checks:
        if shape != (CAPACITY, NUM_CLASSES) or not finite:
            raise AssertionError(f"bad logits: shape {shape}, finite {finite}")
        if any(overflow):
            raise AssertionError(f"points overflowed static capacities: {overflow}")
    for name in kernels:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path ({phase})")
    return launches


def _small_ptv3(amp: bool, **kw) -> dict:
    """PTv3 at small depth for the card-vs-CPU phases: one block a stage,
    the block engine from 4,096 points, wider capacities."""
    return dict(BACKBONE, enc_depths=(1, 1, 1, 1, 1), dec_depths=(1, 1, 1, 1), amp=amp,
                block_engine_min_points=4096, block_capacity_factor=(1 / 8,) * 5,
                pool_capacity_factors=(0.5,) * 4, **kw)


def _cvc_cases(cases):
    return cases if cases is not None else [(amp, dict(MODEL, backbone=_small_ptv3(amp))) for amp in (False, True)]


def _logits(cfg, capacity: int, extent: float, device) -> dict:
    """One eval forward of `cfg` (weights of seed 1) on `device` on the
    `capacity`-point scene of `extent` m: the valid rows' logits, seconds,
    overflow counters."""
    import torch

    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models import build_model

    arrays = scene(100, capacity=capacity, extent=extent)
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    res = model(make_point_batch(arrays, 1, device=device))
    logits = res["seg_logits"].float().cpu().numpy()[arrays["batch"] >= 0]
    return dict(logits=logits, seconds=time.perf_counter() - t0,
                overflow=[int(v) for vs in res["diagnostics"].values() for v in vs])


def _cpu_logits(cfg, capacity: int, extent: float) -> dict:
    """The CPU side of `card_vs_cpu` (plain versions), run by the CPU worker."""
    return _logits(cfg, capacity, extent, "cpu")


def card_vs_cpu_jobs(cases=None, phase="card_vs_cpu", capacity=16384, extent=2.4) -> list:
    """The CPU sides of `card_vs_cpu` with these arguments, as CPU-worker
    jobs (key, function, arguments)."""
    return [(f"{phase}[{amp}]", _cpu_logits, (cfg, capacity, extent)) for amp, cfg in _cvc_cases(cases)]


def card_vs_cpu(device, cases=None, phase="card_vs_cpu", capacity=16384, extent=2.4):
    """Phase 6 (and SpUNet's, PT-v2's): small depth, same weights, a small
    scene of `capacity` points over `extent` m: the port on the card
    (kernels) against the port on the CPU (plain versions, computed by the
    CPU worker). `cases`: (amp, model config) pairs, PTv3 in f32 and AMP by
    default."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # a 2.4 m room at 16,384 points keeps the density of the 102,400-point scenes
    for (amp, cfg), job in zip(_cvc_cases(cases), card_vs_cpu_jobs(cases, phase, capacity, extent)):
        card = _logits(cfg, capacity, extent, device)
        cpu = cpu_result(*job)
        gpu, ref = card["logits"], cpu["logits"]
        rel = float(np.abs(gpu - ref).max() / np.abs(ref).max())
        agree = float((gpu.argmax(1) == ref.argmax(1)).mean())
        max_rel, min_agree = SLICE_BOUNDS[amp]
        emit(phase, amp=amp, points=int(gpu.shape[0]), rel_max_err=rel, bound=max_rel,
             argmax_agreement=agree, agreement_bound=min_agree, cpu_seconds=cpu["seconds"],
             overflow=cpu["overflow"])
        if not (rel < max_rel and agree > min_agree):
            raise AssertionError(f"card and CPU disagree ({phase}, amp={amp}): rel {rel}, agreement {agree}")
        if any(cpu["overflow"]) or cpu["overflow"] != card["overflow"]:
            raise AssertionError(f"{phase}: overflow {cpu['overflow']} (CPU), {card['overflow']} (card)")


def _train_setup(cfg, device, seed, recipe=PTV3_RECIPE, init=None):
    import torch

    from pointcept_tpu_torch.engines import build_train_step
    from pointcept_tpu_torch.models import build_model
    from pointcept_tpu_torch.utils import build_optimizer, build_scheduler

    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    if init is not None:
        init(model)
    optimizer = build_optimizer(recipe["optimizer"], model, recipe["param_dicts"])
    scheduler = build_scheduler(recipe["scheduler"], optimizer, total_steps=TOTAL_STEPS)
    return model, build_train_step(model, optimizer, scheduler)


def _grad_norm(model) -> float:
    import torch

    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad.float()) for p in model.parameters() if p.grad is not None])))


def train_path(device, card, cfg=TRAIN_MODEL, recipe=PTV3_RECIPE, kernels=TRAIN_KERNELS,
               phase="train_path"):
    """Phase 7 (and SpUNet's train phase): the full-width train step, two
    labelled scenes per step."""
    import torch

    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.ops.kernels import KERNELS

    model, step = _train_setup(cfg, device, seed=0, recipe=recipe)
    batches = [scene(seeds, labelled=True) for seeds in TRAIN_SEEDS]
    emit(f"{phase}_setup", capacity=2 * CAPACITY, scenes_per_step=2, seeds=[list(p) for p in TRAIN_SEEDS],
         valid_points=[int((b["batch"] >= 0).sum()) for b in batches],
         parameters=sum(p.numel() for p in model.parameters()), total_steps=TOTAL_STEPS)
    gen = torch.Generator(device=device).manual_seed(7)

    def run(arrays):
        return step(make_point_batch(arrays, 2, device=device), gen)

    run(batches[0])  # warm-up: cuDNN plans for the backward, allocator
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats(device)
    for fn in KERNELS.values():
        fn.launches = 0
    steps = []
    for arrays in batches[1:]:
        t1 = time.perf_counter()
        res = run(arrays)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t1) * 1e3, res=res, grad_norm=_grad_norm(model)))
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    n = len(steps)
    rows = [dict(ms=st["ms"], loss=float(st["res"]["loss"]), grad_norm=st["grad_norm"],
                 pool_overflow=int(st["res"]["pool_overflow"]),
                 block_overflow=int(st["res"]["block_overflow"])) for st in steps]
    for r in rows:
        emit(f"{phase}_step", **r)
    changed = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, model.parameters()))
    emit(phase, card=card, median_step_ms=statistics.median(r["ms"] for r in rows),
         scenes_per_s=2 * n / (sum(r["ms"] for r in rows) / 1e3), peak_memory_bytes=peak,
         losses=[r["loss"] for r in rows], launches=launches,
         launches_per_step={k: v / n for k, v in launches.items()},
         parameters_changed=changed, parameters=len(before))
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"non-finite loss or gradient: {r}")
        if r["pool_overflow"] or r["block_overflow"]:
            raise AssertionError(f"points overflowed static capacities: {r}")
    for name in kernels:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the training path ({phase})")
    if changed != len(before):
        raise AssertionError(f"only {changed} of {len(before)} parameters changed")
    return launches, statistics.median(r["ms"] for r in rows)


def _grad_distance(got: dict, want: dict, vanishing: set, gmax: float):
    """Worst per-tensor relative L2 error of `got` against `want`, its
    tensor, and the lowest cosine, over the tensors not in `vanishing`."""
    import numpy as np

    worst, worst_name, low_cos = 0.0, None, 1.0
    for name, c in want.items():
        g = got[name].astype(np.float64)
        c = c.astype(np.float64)
        if name in vanishing:
            if max(np.abs(c).max(), np.abs(g).max()) > 1e-3 * gmax:
                raise AssertionError(f"{name}: a vanishing gradient above the noise floor")
            continue
        err = float(np.linalg.norm(g - c) / np.linalg.norm(c))
        if err > worst:
            worst, worst_name = err, name
        low_cos = min(low_cos, float(g.ravel() @ c.ravel() / (np.linalg.norm(g) * np.linalg.norm(c))))
    return worst, worst_name, low_cos


def with_instances(arrays: dict) -> dict:
    """`arrays` with PointGroup's targets: the points of classes 2 and up
    grouped into instances by 0.5 m cells of their class, ``instance_centroid``
    each instance's mean coordinate (-1 elsewhere, as `InstanceParser`)."""
    import numpy as np

    seg, valid = arrays["segment"], arrays["batch"] >= 0
    cell = np.floor(arrays["coord"] / 0.5).astype(np.int64)
    key = ((seg.astype(np.int64) * 64 + cell[:, 0]) * 64 + cell[:, 1]) * 64 + cell[:, 2]
    has = valid & (seg >= 2)
    instance = np.full(seg.shape, -1, np.int32)
    _, instance[has] = np.unique(key[has], return_inverse=True)
    centroid = np.full(arrays["coord"].shape, -1.0, np.float32)
    for i in range(instance.max() + 1):
        centroid[instance == i] = arrays["coord"][instance == i].mean(0)
    return dict(arrays, instance=instance, instance_centroid=centroid)


def _cvct_cases(cases):
    if cases is not None:
        return cases
    return [(amp, dict(TRAIN_MODEL, backbone=_small_ptv3(amp, shuffle_orders=True, drop_path=0.0)), PTV3_RECIPE)
            for amp in (False, True)]


def _cvct_data(capacity, extent, condition, instances, batch) -> tuple:
    """The batch of `card_vs_cpu_train` and its nudged copy."""
    import numpy as np

    if batch is not None:
        arrays = dict(batch)
    else:
        arrays = dict(scene(100, capacity=capacity, extent=extent, labelled=True), condition=condition, num_scenes=1)
    if instances:
        arrays = with_instances(arrays)
    nudged = dict(arrays, feat=arrays["feat"] * (1 + 1e-6 * np.random.RandomState(0).randn(
        *arrays["feat"].shape).astype(np.float32)))
    return arrays, nudged


def _train_grads(cfg, recipe, init, data, device) -> tuple:
    """One train step of `cfg` (weights of seed 1, order permutations of a
    CPU generator of seed 5) on `data`: (loss, every gradient as numpy)."""
    import torch

    from pointcept_tpu_torch.engines import make_point_batch

    model, step = _train_setup(cfg, device, seed=1, recipe=recipe, init=init)
    res = step(make_point_batch(data, data["num_scenes"], device=device), torch.Generator().manual_seed(5))
    # (a parameter the step does not reach, as Utonia's mask token, has no gradient)
    return float(res["loss"]), {n: p.grad.float().cpu().numpy() for n, p in model.named_parameters()
                                if p.grad is not None}


def _cpu_train(cfg, recipe, init, capacity, extent, condition, instances, batch) -> dict:
    """The CPU sides of `card_vs_cpu_train` (plain versions), run by the
    CPU worker: the step on the batch and on its nudged copy."""
    arrays, nudged = _cvct_data(capacity, extent, condition, instances, batch)
    return {"cpu": _train_grads(cfg, recipe, init, arrays, "cpu"),
            "cpu_nudged": _train_grads(cfg, recipe, init, nudged, "cpu")}


def card_vs_cpu_train_jobs(cases=None, phase="card_vs_cpu_train", init=None, capacity=16384, extent=2.4,
                           condition=None, instances=False, batch=None, vanishing_below=1e-6) -> list:
    """The CPU sides of `card_vs_cpu_train` with these arguments, as
    CPU-worker jobs (key, function, arguments)."""
    return [(f"{phase}[{amp}]", _cpu_train, (cfg, recipe, init, capacity, extent, condition, instances, batch))
            for amp, cfg, recipe in _cvct_cases(cases)]


def card_vs_cpu_train(device, cases=None, phase="card_vs_cpu_train", init=None, capacity=16384, extent=2.4,
                      condition=None, instances=False, batch=None, vanishing_below=1e-6):
    """Phase 8 (and SpUNet's): one train step of the small-depth model on
    the card and on the CPU, same weights, batch and order permutations
    (drawn from a CPU generator of one seed; drop path 0, so nothing else is
    drawn). `cases`: (amp, model config, recipe), PTv3 in f32 and AMP by
    default; the first must be f32. The CPU steps run in the CPU worker.

    The gradients of one step are sensitive by nature: attention operands
    round to bf16 and pooling takes a max, so a change of the input far
    below any rounding moves some gradient tensors by several percent. The
    run measures that noise floor itself: the CPU step again, on features
    scaled by 1 + 1e-6 * N(0, 1). The card must agree with the CPU within
    the slice test's bounds, or within twice the floor where the floor of
    this model and scene is above them. `init(model)` (a module-level
    function, for the worker) changes the weights after the build, the same
    on both devices. `capacity`, `extent`: the scene's points and size;
    `condition`: the batch's (PPT); `instances`: PointGroup's targets
    (`with_instances`); `batch`: a collated batch (with ``num_scenes``) in
    place of the scene (the classifiers' clouds); `vanishing_below`: the
    share of the largest gradient under which a tensor's CPU gradient
    counts as vanishing (PT-v2's biases before its norms sit at 1e-8 to
    6e-6 of it, the Linear(3, C) ones before its position norms above 1e-6,
    its other tensors at 7e-4 and more)."""
    import numpy as np

    arrays, _ = _cvct_data(capacity, extent, condition, instances, batch)
    jobs = card_vs_cpu_train_jobs(cases, phase, init, capacity, extent, condition, instances, batch)
    vanishing = set()
    for (amp, cfg, recipe), job in zip(_cvct_cases(cases), jobs):
        out = dict(card=_train_grads(cfg, recipe, init, arrays, device), **cpu_result(*job))
        (gl, gg), (cl, cg), (nl, ng) = out["card"], out["cpu"], out["cpu_nudged"]
        gmax = max(float(np.abs(g).max()) for g in cg.values())
        if not amp:
            # biases that feed only train-mode BatchNorms: zero gradient in
            # exact arithmetic, rounding noise on both devices
            vanishing = {n for n, c in cg.items() if np.abs(c).max() < vanishing_below * gmax}
        worst, worst_name, low_cos = _grad_distance(gg, cg, vanishing, gmax)
        floor, floor_name, floor_cos = _grad_distance(ng, cg, vanishing, gmax)
        max_loss, max_grad, min_cos = TRAIN_BOUNDS[amp]
        max_grad = max(max_grad, 2 * floor)
        min_cos = min(min_cos, 1 - 2 * (1 - floor_cos))
        rel_loss = abs(gl - cl) / abs(cl)
        # the five furthest tensors, each beside its own noise floor
        errs = {n: _grad_distance({n: gg[n]}, {n: c}, set(), gmax)[0] for n, c in cg.items() if n not in vanishing}
        furthest = [dict(tensor=n, rel_l2=errs[n], floor=_grad_distance({n: ng[n]}, {n: cg[n]}, set(), gmax)[0])
                    for n in sorted(errs, key=errs.get, reverse=True)[:5]]
        emit(phase, amp=amp, loss=[gl, cl], rel_loss_err=rel_loss,
             worst_grad_rel_l2=worst, worst_tensor=worst_name, min_cos=low_cos,
             noise_floor=dict(loss=nl, grad_rel_l2=floor, tensor=floor_name, min_cos=floor_cos),
             vanishing_tensors=len(vanishing), bounds=[max_loss, max_grad, min_cos], furthest_tensors=furthest)
        if not (rel_loss < max_loss and worst < max_grad and low_cos > min_cos):
            raise AssertionError(f"card and CPU train steps disagree ({phase}, amp={amp})")


def write_scannet_scenes(root: str) -> dict:
    """Synthetic scenes in ScanNet's preprocessed layout, one directory of
    .npy files a scene (`coord`, `color` as uint8, `normal`, `segment20`,
    `segment200`, `instance`): a 6 m room of RAW_POINTS points, the
    benchmark's scene before its voxelisation. Returns the points a split."""
    sizes = {}
    for split, seeds in SCANNET_SEEDS.items():
        for seed in seeds:
            sizes.setdefault(split, []).append(write_scannet_scene(root, split, seed))
    return sizes


def write_scannet_scene(root: str, split: str, seed: int, points: int = RAW_POINTS) -> int:
    """One synthetic scene of `points` points in a 6 m room, in ScanNet's
    layout under ``root/split/scene{seed:04d}_00``; returns its points."""
    from pointcept_tpu_torch.datasets import synthesize_scene

    import numpy as np

    d = os.path.join(root, split, f"scene{seed:04d}_00")
    os.makedirs(d)
    sc = synthesize_scene(seed, num_points=points, num_classes=NUM_CLASSES, extent=6.0)
    np.save(os.path.join(d, "coord.npy"), sc["coord"])
    np.save(os.path.join(d, "color.npy"), sc["color"].astype(np.uint8))
    np.save(os.path.join(d, "normal.npy"), sc["normal"])
    np.save(os.path.join(d, "segment20.npy"), sc["segment"].astype(np.int16))
    # 200 classes: each of the 20 split by the object (instance) it belongs to
    np.save(os.path.join(d, "segment200.npy"), (sc["segment"] * 10 + sc["instance"] % 10).astype(np.int16))
    np.save(os.path.join(d, "instance.npy"), sc["instance"].astype(np.int16))
    return len(sc["coord"])


_LOGS = {}


def _quiet(fn, log_path: str):
    """`fn()` with the trainer's and tester's log lines (their console
    handler writes to stdout) sent to `log_path`, so that this script's own
    lines stay readable; the log's tail goes to stderr if `fn` raises. The
    file stays open: a handler made under the redirect keeps writing to it."""
    log = _LOGS.get(log_path)
    if log is None:
        log = _LOGS[log_path] = open(log_path, "a")
    try:
        with contextlib.redirect_stdout(log):
            return fn()
    except BaseException:
        log.flush()
        with open(log_path) as f:
            print(f.read()[-4000:], file=sys.stderr)
        raise


def _metrics(save_path: str) -> list:
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def trainer_path(device, card, work: str, bare_step_ms: float):
    """Phase 10: the ScanNet config through the port's trainer at full
    width and its steady state; returns its second epoch resumed through
    the CLI, started (`start_resume`)."""
    import torch

    from pointcept_tpu_torch.engines import default_config_parser, main_worker
    from pointcept_tpu_torch.models import apply_amp_policy, build_model
    from pointcept_tpu_torch.ops.kernels import KERNELS

    data_root = os.path.join(work, "scannet")
    sizes = write_scannet_scenes(data_root)
    options = dict(TRAINER_OPTIONS, **{"data.train.data_root": data_root, "data.val.data_root": data_root})
    first = os.path.join(work, "run")
    cfg = default_config_parser(os.path.join(ROOT, SCANNET_CONFIG), dict(options, save_path=first))
    emit("trainer_setup", config=SCANNET_CONFIG, options=options, raw_points=sizes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = _quiet(lambda: main_worker(cfg), os.path.join(work, "trainer.log"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    rows = _metrics(first)
    evals = trainer.comm_info["eval_result"]
    initial = build_model(apply_amp_policy(dict(cfg.model), cfg.enable_amp), device=device,
                          generator=torch.Generator().manual_seed(cfg.shared_seed))
    unchanged = [n for (n, a), b in zip(initial.named_parameters(), trainer.model.parameters())
                 if torch.equal(a, b.detach())]
    n_params = sum(p.numel() for p in trainer.model.parameters())
    del initial
    files = sorted(os.listdir(os.path.join(first, "model")))
    steps = [dict(epoch=r["epoch"], iter=r["iter"], loss=r["loss"], batch_time_ms=r["batch_time"] * 1e3,
                  data_time_ms=r["data_time"] * 1e3, pool_overflow=r["pool_overflow"],
                  block_overflow=r["block_overflow"]) for r in rows]
    for st in steps:
        emit("trainer_step", **st)
    emit("trainer", card=card, seconds=seconds, parameters=n_params, steps=len(steps),
         **_step_times(steps), bare_step_median_ms=bare_step_ms, eval_ms_per_scene=evals["batch_ms"],
         val_mIoU=evals["mIoU"], val_overflow=evals["overflow"], best_metric_value=trainer.best_metric_value,
         peak_memory_bytes=peak, launches=launches, unchanged_parameters=len(unchanged), checkpoints=files)
    if len(steps) != 4 or not all(math.isfinite(st["loss"]) for st in steps):
        raise AssertionError(f"trainer: expected 4 finite losses, got {[st['loss'] for st in steps]}")
    if any(st["pool_overflow"] or st["block_overflow"] for st in steps) or evals["overflow"]:
        raise AssertionError("trainer: points overflowed static capacities")
    if not math.isfinite(evals["mIoU"]):
        raise AssertionError(f"trainer: val mIoU {evals['mIoU']}")
    if unchanged:
        raise AssertionError(f"trainer: {len(unchanged)} parameters not updated, e.g. {unchanged[:3]}")
    if not {"model_last.pth", "model_best.pth", "epoch_1.pth"} <= set(files):
        raise AssertionError(f"trainer: checkpoints missing, found {files}")
    for name in TRAIN_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the trainer")
    del trainer
    release()

    steady_state(device, card, work, dict(options, **STEADY_OPTIONS), bare_step_ms)
    # the resumed epoch runs beside phases 11-12 (its ~20 GB beside their 10 GB)
    return start_resume(work, SCANNET_CONFIG, options, first, "trainer")


def _step_times(steps: list) -> dict:
    """The window's mean batch_time over every step, and the medians of the
    steps that are not the first of their epoch (the first waits for the
    loader's workers to start)."""
    later = [st for prev, st in zip(steps, steps[1:]) if st["epoch"] == prev["epoch"]]
    return dict(window_ms_per_step=statistics.fmean(st["batch_time_ms"] for st in steps),
                median_batch_time_ms=statistics.median(st["batch_time_ms"] for st in steps),
                median_data_time_ms=statistics.median(st["data_time_ms"] for st in steps),
                later_steps=len(later),
                later_median_batch_time_ms=statistics.median(st["batch_time_ms"] for st in later),
                later_median_data_time_ms=statistics.median(st["data_time_ms"] for st in later),
                later_median_step_ms=statistics.median(st["batch_time_ms"] - st["data_time_ms"] for st in later))


def steady_state(device, card, work: str, options: dict, bare_step_ms: float):
    """Phase 10's steady state: the same config and scenes through the
    trainer for one epoch of STEADY_STEPS steps, then the trainer's own train step
    alone on batches of its loader (no hooks, no loader), which the
    trainer's steps are held against beside phase 7's bare step."""
    import torch

    from pointcept_tpu_torch.engines import build_train_step, default_config_parser, main_worker, make_point_batch

    save = os.path.join(work, "steady")
    cfg = default_config_parser(os.path.join(ROOT, SCANNET_CONFIG), dict(options, save_path=save))

    def run():
        trainer = main_worker(cfg)
        trainer.train_loader.set_epoch(0)
        batches = []
        for batch in trainer.train_loader:
            batches.append(make_point_batch(batch, batch["num_scenes"], device=device))
            if len(batches) == BARE_STEPS // 2:
                break
        step = build_train_step(trainer.model, trainer.optimizer, trainer.build_scheduler(), cfg.get("clip_grad"))
        return trainer, batches, step

    trainer, batches, step = _quiet(run, os.path.join(work, "trainer.log"))
    steps = [dict(epoch=r["epoch"], batch_time_ms=r["batch_time"] * 1e3, data_time_ms=r["data_time"] * 1e3,
                  overflow=r["pool_overflow"] + r["block_overflow"]) for r in _metrics(save)]
    generator = torch.Generator(device=device)
    bare = []
    for i in range(BARE_STEPS):
        generator.manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(batches[i % len(batches)], generator)
        torch.stack([res["loss"].float(), res["pool_overflow"].float(), res["block_overflow"].float()]).tolist()
        bare.append((time.perf_counter() - t0) * 1e3)
    emit("trainer_steady", card=card, options=STEADY_OPTIONS, steps=len(steps),
         batch_time_ms=[st["batch_time_ms"] for st in steps], data_time_ms=[st["data_time_ms"] for st in steps],
         **_step_times(steps), config_bare_step_ms=bare, config_bare_step_median_ms=statistics.median(bare),
         bare_step_median_ms=bare_step_ms)
    if len(steps) != STEADY_STEPS or any(st["overflow"] for st in steps):
        raise AssertionError(f"trainer steady state: {len(steps)} steps, overflow {[st['overflow'] for st in steps]}")
    del trainer, batches, step
    release()


def _test_main_worker():
    """`main_worker` of `tools/torch_port_test.py`, the test CLI's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_port_test", os.path.join(ROOT, "tools", "torch_port_test.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main_worker


def _median(values):
    return statistics.median(values) if values else None


def tester_path(device, card, work: str):
    """Phase 11: the ScanNet config's test section through the test CLI's
    `main_worker`, on phase 10's weights and val scene 5 at TESTER_POINTS."""
    test_root = os.path.join(work, "scannet_test")
    raw = write_scannet_scene(test_root, "val", int(TESTER_SCENE[5:9]), TESTER_POINTS)
    models = os.path.join(work, "run", "model")
    weight = os.path.join(models, "model_best.pth")
    if not os.path.isfile(weight):
        weight = os.path.join(models, "model_last.pth")
    options = dict(TESTER_OPTIONS, weight=weight, **{"data.test.data_root": test_root})
    emit("tester_setup", config=SCANNET_CONFIG, options=dict(options, weight=os.path.relpath(weight, work)))
    test_scene(device, card, work, "tester", SCANNET_CONFIG, TESTER_SCENE, raw, options)


def test_scene(device, card, work: str, phase: str, config: str, scene_name: str, raw_points: int,
               options: dict, kernels=None, after=None):
    """A config's test section through the test CLI's `main_worker` on one
    scene, launch counters set to 0 just before and read just after:
    nothing dropped, the preds finite at full resolution and as wide as the
    config's classes, their mass the fragment points' count and every point
    voted by every view, each of `kernels` launched (by default PTv3's eval
    kernels, attention alone for an ``enc_mode`` encoder). `after(tester,
    pred)` runs before the tester goes. Returns the scene's stats."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.engines import default_config_parser
    from pointcept_tpu_torch.ops.kernels import KERNELS

    main_worker = _test_main_worker()
    save = os.path.join(work, phase)
    cfg = default_config_parser(os.path.join(ROOT, config), dict(options, save_path=save))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    tester, result = _quiet(lambda: main_worker(cfg), os.path.join(work, "tester.log"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    (st,) = tester.scene_stats
    pred = np.load(os.path.join(save, "result", f"{scene_name}_pred.npy"))
    # each fragment point adds one softmax (mass 1), and every view holds
    # every voxel, so each point has at least one vote a view
    views = len(cfg.data.test.test_cfg.aug_transform)
    votes = pred.sum(axis=1, dtype=np.float64)
    mass_err = abs(float(votes.sum()) - st["points"]) / st["points"]
    geometry_ms = st.get("geometry_ms", [])
    emit(phase, config=config, card=card, seconds=seconds, parameters=sum(p.numel() for p in tester.model.parameters()),
         capacity=tester.test_capacity, fragments=st["fragments"], groups=st["groups"], forwards=st["forwards"],
         fragment_batch=st["batch"], scene_ms=st["scene_ms"], fragments_per_s=st["fragments"] / (st["scene_ms"] / 1e3),
         median_forward_ms=_median(st["forward_ms"]), forward_ms_range=[min(st["forward_ms"]), max(st["forward_ms"])],
         median_geometry_ms=_median(geometry_ms), geometry_ms_total=sum(geometry_ms),
         forward_ms_total=sum(st["forward_ms"]), device_ms_timed=sum(geometry_ms) + sum(st["forward_ms"]),
         host_ms=st["host_ms"], loader_wait_ms=st["loader_wait_ms"], peak_memory_bytes=peak, dropped=st["dropped"],
         raw_points=int(pred.shape[0]), fragment_points=st["points"], vote_mass_rel_err=mass_err,
         min_votes=float(votes.min()), views=views, mIoU=result["mIoU"], mAcc=result["mAcc"],
         allAcc=result["allAcc"], launches=launches)
    if st["dropped"]:
        raise AssertionError(f"{phase}: {st['dropped']} points dropped by static capacities")
    if pred.shape != (raw_points, cfg.data.num_classes) or not np.isfinite(pred).all():
        raise AssertionError(f"{phase}: pred of shape {pred.shape}, finite {np.isfinite(pred).all()}")
    if mass_err > 1e-4 or votes.min() < views * (1 - 1e-4):
        raise AssertionError(f"{phase}: votes off: mass {mass_err} relative, least {votes.min()} of {views} views")
    if kernels is None:
        kernels = ("patch_attention",) if tester.model.backbone.enc_mode else EVAL_KERNELS
    for name in kernels:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the tester ({phase})")
    if after is not None:
        after(tester, pred)
    del tester
    release()
    return st


def overfit_tester(device, card, work: str, path: str, options: dict, save: str):
    """Phase 12's tester: the overfit config's own test section on its
    trained weights, on the card, again from the cached preds, then on the
    CPU (plain versions)."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.engines import default_config_parser
    from pointcept_tpu_torch.ops.kernels import KERNELS

    main_worker = _test_main_worker()
    weight = os.path.join(save, "model", "model_last.pth")
    runs = {}
    for name, dev in (("card", None), ("cpu", "cpu")):
        out = os.path.join(save, f"tester_{name}")
        cfg = default_config_parser(os.path.join(ROOT, path), dict(options, save_path=out, weight=weight))
        for fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        tester, result = _quiet(lambda: main_worker(cfg, device=dev), os.path.join(work, "tester.log"))
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in KERNELS.items()}
        stats = list(tester.scene_stats)
        again = _quiet(tester.test, os.path.join(work, "tester.log"))
        preds = {f: np.load(os.path.join(out, "result", f)) for f in sorted(os.listdir(os.path.join(out, "result")))
                 if f.endswith("_pred.npy")}
        runs[name] = dict(result=result, again=again, preds=preds, seconds=seconds, launches=launches,
                          dropped=[st["dropped"] for st in stats], forwards=sum(st["forwards"] for st in stats),
                          fragments=sum(st["fragments"] for st in stats), reran=len(tester.scene_stats))
        del tester
    card_run, cpu_run = runs["card"], runs["cpu"]
    rel = max(float(np.abs(card_run["preds"][f] - p).max() / np.abs(p).max()) for f, p in cpu_run["preds"].items())
    agree = min(float((card_run["preds"][f].argmax(1) == p.argmax(1)).mean()) for f, p in cpu_run["preds"].items())
    d_miou = abs(card_run["result"]["mIoU"] - cpu_run["result"]["mIoU"])
    emit("overfit_tester", config=path, card=card, result=card_run["result"], cached_result=card_run["again"],
         cpu_result=cpu_run["result"], scenes=len(card_run["preds"]), fragments=card_run["fragments"],
         forwards=card_run["forwards"], seconds=card_run["seconds"], cpu_seconds=cpu_run["seconds"],
         dropped=card_run["dropped"], cpu_dropped=cpu_run["dropped"], rel_max_err=rel, argmax_agreement=agree,
         mIoU_diff=d_miou, bounds=TESTER_CPU_BOUNDS, launches=card_run["launches"])
    res = card_run["result"]
    if not (res["mIoU"] > 0.80 and res["allAcc"] > 0.90):
        raise AssertionError(f"{path}: tester mIoU {res['mIoU']}, allAcc {res['allAcc']}")
    if card_run["again"] != res or cpu_run["again"] != cpu_run["result"] or card_run["reran"] or cpu_run["reran"]:
        raise AssertionError(f"{path}: the tester's second run from its cached preds differs")
    if any(card_run["dropped"]) or any(cpu_run["dropped"]):
        raise AssertionError(f"{path}: the tester dropped points")
    if card_run["preds"].keys() != cpu_run["preds"].keys() or not card_run["preds"]:
        raise AssertionError(f"{path}: the card's and the CPU's preds cover different scenes")
    b = TESTER_CPU_BOUNDS
    if not (rel < b["rel"] and agree > b["agreement"] and d_miou < b["miou"]):
        raise AssertionError(f"{path}: the tester on the card and on the CPU disagree")
    # the overfit model's convs take the gather engine: attention is its one kernel
    if card_run["launches"]["patch_attention"] == 0:
        raise AssertionError("kernel patch_attention was not launched by the overfit tester")
    release()


def overfit_runs(device, card, work: str):
    """Phase 12: the overfit configs through the trainer (the thresholds of
    tests/test_overfit.py), then PTv3's through the tester."""
    import torch

    from pointcept_tpu_torch.engines import default_config_parser, main_worker

    for path, options in OVERFIT_CONFIGS.items():
        save = os.path.join(work, os.path.basename(path)[: -len(".py")])
        t0 = time.perf_counter()
        cfg = default_config_parser(os.path.join(ROOT, path), dict(options, save_path=save))
        trainer = _quiet(lambda: main_worker(cfg), os.path.join(work, "trainer.log"))
        seconds = time.perf_counter() - t0
        rows = _metrics(save)
        loss = trainer.comm_info["metrics"]["loss"]
        miou = trainer.comm_info["current_metric_value"]
        overflow = max(r["pool_overflow"] + r["block_overflow"] for r in rows)
        val_overflow = trainer.comm_info["eval_result"]["overflow"]
        emit("overfit", config=path, options=options, card=card, seconds=seconds, steps=len(rows),
             loss_at_step={i: rows[i - 1]["loss"] for i in (1, 50, 100, 150) if i <= len(rows)},
             final_loss=loss, val_mIoU=miou,
             median_batch_time_ms=statistics.median(r["batch_time"] for r in rows) * 1e3,
             max_overflow_per_step=overflow, val_overflow=val_overflow)
        if not (loss < 0.05 and miou > 0.80):
            raise AssertionError(f"{path}: final train loss {loss}, val mIoU {miou}")
        if overflow or val_overflow:
            raise AssertionError(f"{path}: points overflowed static capacities ({overflow} in a step, "
                                 f"{val_overflow} in eval)")
        del trainer
        release()
        if "pt-v3" in path:
            overfit_tester(device, card, work, path, options, save)


def _hyper_rows(model, steps_per_epoch: int, epochs: int, start_epoch: int = 0) -> list:
    """SonataHook's values of every step of a run, on the host alone."""
    from types import SimpleNamespace

    from pointcept_tpu_torch.engines.hooks import SonataHook

    hook = SonataHook()
    hook.trainer = SimpleNamespace(model=model, train_loader=[None] * steps_per_epoch, max_epoch=epochs,
                                   start_epoch=start_epoch, comm_info={},
                                   storage=SimpleNamespace(put_scalar=lambda *a, **k: None))
    hook.before_train()
    rows = []
    for _ in range((epochs - start_epoch) * steps_per_epoch):
        hook.before_step()
        rows.append(dict(hook.trainer.comm_info["model_hyper"]))
    return rows


def sonata_path(device, card, work: str):
    """Phase 13: the Sonata pretraining config through the port's trainer at
    full width on phase 10's train scenes; its hooks' values, the EMA and
    the checkpoint; its steady state; one small-depth step on the card
    against the CPU; then the supervised PT-v3m2 config. Returns the
    arguments of its resumed epoch (`start_resume`), which runs later."""
    import torch

    from pointcept_tpu_torch.engines import default_config_parser, main_worker
    from pointcept_tpu_torch.models import apply_amp_policy, build_model
    from pointcept_tpu_torch.ops.kernels import KERNELS

    options = dict(SONATA_OPTIONS, **{"data.train.data_root": os.path.join(work, "scannet")})
    first = os.path.join(work, "sonata")
    cfg = default_config_parser(os.path.join(ROOT, SONATA_CONFIG), dict(options, save_path=first))
    bb = cfg.model.backbone
    emit("sonata_setup", config=SONATA_CONFIG, options=options, enc_channels=bb.enc_channels,
         enc_depths=bb.enc_depths, enc_num_head=bb.enc_num_head, heads=[cfg.model.head_hidden_channels,
         cfg.model.head_embed_channels, cfg.model.head_num_prototypes], views=SONATA_VIEWS, amp=cfg.enable_amp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = _quiet(lambda: main_worker(cfg), os.path.join(work, "trainer.log"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    rows = _metrics(first)
    losses = ("loss", "mask_loss", "roll_mask_loss", "unmask_loss")
    steps = [dict(epoch=r["epoch"], iter=r["iter"], **{k: r[k] for k in losses}, batch_time_ms=r["batch_time"] * 1e3,
                  data_time_ms=r["data_time"] * 1e3, pool_overflow=r["pool_overflow"],
                  block_overflow=r["block_overflow"], collate_dropped=r["collate_dropped"],
                  **{k[len("params/"):]: r[k] for k in r if k.startswith("params/")}) for r in rows]
    for st in steps:
        emit("sonata_step", **st)
    per_epoch = len(trainer.train_loader)
    want_hyper = _hyper_rows(trainer.model, per_epoch, trainer.max_epoch)
    hyper_ok = len(steps) == len(want_hyper) and all(
        st[k] == w[k] for st, w in zip(steps, want_hyper) for k in w)
    wd_hook = next(h for h in cfg.hooks if h["type"] == "WeightDecaySchedular")
    base, final = wd_hook["base_value"], wd_hook["final_value"]
    want_wd = {e + 1: final + 0.5 * (base - final) * (1 + math.cos(math.pi * e / trainer.max_epoch))
               for e in range(trainer.max_epoch)}
    got_wd = {st["epoch"]: st["weight_decay"] for st in steps if "weight_decay" in st}
    wd_ok = got_wd.keys() == want_wd.keys() and all(abs(got_wd[e] - want_wd[e]) < 1e-12 for e in want_wd)
    initial = build_model(apply_amp_policy(dict(cfg.model), cfg.enable_amp), device=device,
                          generator=torch.Generator().manual_seed(cfg.shared_seed))
    unchanged = [n for (n, a), b in zip(initial.student.named_parameters(), trainer.model.student.parameters())
                 if torch.equal(a, b.detach())]
    del initial
    ckpt = torch.load(os.path.join(first, "model", "epoch_1.pth"), map_location="cpu", weights_only=False)["state_dict"]
    teacher_keys = [k for k in ckpt if k.startswith("teacher.")]
    teacher_differs = any(not torch.equal(ckpt[k], ckpt["student." + k[len("teacher."):]]) for k in teacher_keys
                          if k.endswith("weight"))
    ckpt_ok = (len(teacher_keys) == sum(1 for k in trainer.model.state_dict() if k.startswith("teacher."))
               and teacher_differs)
    del ckpt
    n_steps = len(steps)
    fwd_per_step = launches["patch_attention"] / max(n_steps, 1)
    bwd_per_step = launches["patch_attention_bwd"] / max(n_steps, 1)
    blocks = sum(bb.enc_depths)
    emit("sonata", card=card, seconds=seconds, parameters=sum(p.numel() for p in trainer.model.parameters()),
         trainable=sum(p.numel() for p in trainer.model.parameters() if p.requires_grad), steps=n_steps,
         **_step_times(steps), peak_memory_bytes=peak, launches=launches,
         attention_fwd_per_step=fwd_per_step, attention_bwd_per_step=bwd_per_step,
         head_in_channels=[trainer.model.head_in_channels, trainer.model.config_head_in_channels],
         hyper_match=hyper_ok, weight_decay=got_wd, weight_decay_match=wd_ok,
         unchanged_student_parameters=len(unchanged), checkpoint_teacher_tensors=len(teacher_keys))
    if n_steps != 4 or not all(math.isfinite(st[k]) for st in steps for k in losses):
        raise AssertionError(f"sonata: expected 4 steps of finite losses, got {steps}")
    if any(st["pool_overflow"] or st["block_overflow"] or st["collate_dropped"] for st in steps):
        raise AssertionError("sonata: points overflowed static capacities or the collate subsampled")
    if not (hyper_ok and wd_ok):
        raise AssertionError("sonata: scheduled values differ from SonataHook's or the cosine weight decay")
    if unchanged:
        raise AssertionError(f"sonata: {len(unchanged)} student parameters not updated, e.g. {unchanged[:3]}")
    if not ckpt_ok:
        raise AssertionError("sonata: epoch_1.pth does not hold the teacher")
    if fwd_per_step != 3 * blocks or bwd_per_step != 2 * blocks:
        raise AssertionError(f"sonata: {fwd_per_step} attention forwards and {bwd_per_step} backwards a step, "
                             f"expected {3 * blocks} and {2 * blocks}")
    sonata_ema_check(trainer, device)
    del trainer
    release()

    # the steady state: one epoch of STEADY_STEPS steps
    save = os.path.join(work, "sonata_steady")
    cfg = default_config_parser(os.path.join(ROOT, SONATA_CONFIG), dict(options, save_path=save, **SONATA_STEADY))
    torch.cuda.reset_peak_memory_stats(device)
    trainer = _quiet(lambda: main_worker(cfg), os.path.join(work, "trainer.log"))
    peak = torch.cuda.max_memory_allocated(device)
    steady = [dict(epoch=r["epoch"], batch_time_ms=r["batch_time"] * 1e3, data_time_ms=r["data_time"] * 1e3,
                   overflow=r["pool_overflow"] + r["block_overflow"] + r["collate_dropped"]) for r in _metrics(save)]
    emit("sonata_steady", card=card, options=SONATA_STEADY, steps=len(steady),
         batch_time_ms=[st["batch_time_ms"] for st in steady], data_time_ms=[st["data_time_ms"] for st in steady],
         **_step_times(steady), peak_memory_bytes=peak)
    if len(steady) != STEADY_STEPS or any(st["overflow"] for st in steady):
        raise AssertionError(f"sonata steady state: {len(steady)} steps, overflow {[st['overflow'] for st in steady]}")
    del trainer
    release()
    sonata_card_vs_cpu(device)
    scratch_path(device, card, work)
    # the resumed epoch (~51 GB) runs later, beside phase 17 (~10 GB)
    return (work, SONATA_CONFIG, options, first, "sonata", losses)


def sonata_ema_check(trainer, device):
    """One more step of the trained model on a batch of its loader: every
    teacher tensor afterwards is ``(m * t) + ((1 - m) * s)`` of its copy
    taken before the step and the updated student, bit for bit."""
    import torch

    from pointcept_tpu_torch.engines import build_train_step, make_inputs

    trainer.train_loader.num_workers = 0
    batch = next(iter(trainer.train_loader))
    hyper = _hyper_rows(trainer.model, len(trainer.train_loader), trainer.max_epoch)[-1]
    teacher = dict(trainer.model.teacher.named_parameters())
    before = {n: p.detach().clone() for n, p in teacher.items()}
    step = build_train_step(trainer.model, trainer.optimizer, trainer.build_scheduler(), trainer.cfg.get("clip_grad"))
    step(make_inputs(batch, device=device), torch.Generator(device=device).manual_seed(1), hyper)
    m = hyper["momentum"]
    student = dict(trainer.model.student.named_parameters())
    same = {n: bool(torch.equal(p, (m * before[n]) + ((1.0 - m) * student[n].detach()))) for n, p in teacher.items()}
    named = {n: same.get(n[len("teacher."):]) for n in SONATA_EMA_NAMES}
    moved = sum(int(not torch.equal(before[n], p)) for n, p in teacher.items())
    emit("sonata_ema", momentum=m, named=named, teacher_tensors=len(same), follow_the_formula=sum(same.values()),
         moved=moved)
    if not all(same.values()):
        raise AssertionError(f"sonata: teacher tensors off the EMA: {[n for n, ok in same.items() if not ok][:5]}")


def _sonata_case() -> dict:
    """The small-depth Sonata step of `sonata_card_vs_cpu`: its model and
    recipe, the batch (the config's pipeline on a small scene, numpy's and
    Python's generators at seed 0), its nudged copy, the mask scores and the
    hyper-parameters."""
    import random

    import numpy as np
    import torch

    from pointcept_tpu_torch.datasets import Compose, point_collate_fn, synthesize_scene
    from pointcept_tpu_torch.utils.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, SONATA_CONFIG))
    # pool factors 0.85: the views of one small scene fill its capacity
    # closer than two full scenes fill 262,144 rows (at 0.75 the 5,000-point
    # scene drops 80 points)
    model_cfg = dict(cfg.model, backbone=dict(cfg.model.backbone, enc_depths=(1,) * 5, shuffle_orders=False,
                                              drop_path=0.0, pool_capacity_factors=(0.85,) * 4))
    pipeline = Compose([t for t in cfg.data.train.transform])
    # its transforms draw from numpy's and Python's generators: both seeded,
    # so that this process and the CPU worker make the same batch
    np.random.seed(0)
    random.seed(0)
    # the point density of phase 10's scenes (409,600 points in a 6 m room),
    # at an eighth of the scene this phase first had (20,000 points, 1.4 m:
    # its CPU steps took 95-108 s of the time limit; 10,000 at 1.0 m took 99
    # s of the whole phase, 5,000 at 0.7 m 71 s)
    sample = synthesize_scene(100, num_points=2500, num_classes=NUM_CLASSES, extent=0.5)
    sample = pipeline(dict(coord=sample["coord"], color=sample["color"].astype(np.float32),
                           normal=sample["normal"]))
    need = max(int(sample["global_offset"][-1]), int(sample["local_offset"][-1]))
    arrays = point_collate_fn([sample], capacity=-(-need // 1024) * 1024)
    nudged = dict(arrays)
    for key in ("global_feat", "local_feat"):
        nudged[key] = arrays[key] * (1 + 1e-6 * np.random.RandomState(0).randn(*arrays[key].shape).astype(np.float32))
    return dict(model_cfg=model_cfg, optimizer=dict(cfg.optimizer), param_dicts=cfg.param_dicts,
                scheduler=dict(cfg.scheduler), arrays=arrays, nudged=nudged,
                scores=torch.rand(arrays["global_coord"].shape[0], generator=torch.Generator().manual_seed(3)),
                hyper=dict(mask_size=0.4, mask_ratio=0.5, teacher_temp=0.07, momentum=0.996))


def _sonata_step(case: dict, data: dict, dev) -> dict:
    """One Sonata train step of `case` on `data` on `dev`: the losses,
    overflow, the student's gradients and the seconds."""
    import torch

    from pointcept_tpu_torch.engines import build_train_step, make_inputs
    from pointcept_tpu_torch.models import build_model
    from pointcept_tpu_torch.utils import build_optimizer, build_scheduler

    model = build_model(case["model_cfg"], device=dev, generator=torch.Generator().manual_seed(1))
    forward = model.forward
    model.forward = lambda d, generator=None, hyper=None, f=forward, s=case["scores"].to(dev): f(
        d, generator, hyper, mask_scores=s)
    optimizer = build_optimizer(case["optimizer"], model, case["param_dicts"])
    step = build_train_step(model, optimizer, build_scheduler(case["scheduler"], optimizer, TOTAL_STEPS))
    t0 = time.perf_counter()
    res = step(make_inputs(data, device=dev), torch.Generator(device=dev), case["hyper"])
    return dict(losses={k: float(v) for k, v in res.items() if k.endswith("loss")},
                overflow=int(res["pool_overflow"]) + int(res["block_overflow"]),
                grads={n: p.grad.float().cpu().numpy() for n, p in model.student.named_parameters()},
                seconds=time.perf_counter() - t0)


def _cpu_sonata() -> dict:
    """The CPU sides of `sonata_card_vs_cpu`, run by the CPU worker."""
    case = _sonata_case()
    return {"cpu": _sonata_step(case, case["arrays"], "cpu"), "cpu_nudged": _sonata_step(case, case["nudged"], "cpu")}


SONATA_CPU_JOB = ("sonata_card_vs_cpu", _cpu_sonata, ())


def sonata_card_vs_cpu(device, phase: str = "sonata_card_vs_cpu"):
    """One small-depth Sonata train step (the config's widths and heads, one
    block a stage, pool factors 0.85, in f32: under AMP a 1e-6 nudge of the
    input moves some gradient tensors by their own size; orders unshuffled,
    drop path 0) on
    the card and on the CPU (the CPU worker), same weights, batch (the
    config's pipeline on a small scene) and mask scores: losses and student
    gradients against the slice's bounds, or twice the CPU's own noise floor
    (the step again on features nudged by 1e-6)."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    case = _sonata_case()
    arrays = case["arrays"]
    out = dict(card=_sonata_step(case, arrays, device), **cpu_result(*SONATA_CPU_JOB))
    card, cpu, floor_run = out["card"], out["cpu"], out["cpu_nudged"]
    gmax = max(float(np.abs(g).max()) for g in cpu["grads"].values())
    # biases that feed only the poolings' train-mode BatchNorms: zero
    # gradient in exact arithmetic, rounding noise on both devices
    vanishing = {n for n, c in cpu["grads"].items() if np.abs(c).max() < 1e-6 * gmax}
    worst, worst_name, low_cos = _grad_distance(card["grads"], cpu["grads"], vanishing, gmax)
    floor, floor_name, floor_cos = _grad_distance(floor_run["grads"], cpu["grads"], vanishing, gmax)
    max_loss, max_grad, min_cos = TRAIN_BOUNDS[False]
    max_grad = max(max_grad, 2 * floor)
    min_cos = min(min_cos, 1 - 2 * (1 - floor_cos))
    rel_loss = {k: abs(card["losses"][k] - v) / abs(v) for k, v in cpu["losses"].items()}
    floor_loss = {k: abs(floor_run["losses"][k] - v) / abs(v) for k, v in cpu["losses"].items()}
    loss_bound = {k: max(max_loss, 2 * floor_loss[k]) for k in rel_loss}
    emit(phase, amp=False, points=[int((arrays[f"{p}_batch"] >= 0).sum()) for p in ("global", "local")],
         losses=[card["losses"], cpu["losses"]], rel_loss_err=rel_loss, loss_bounds=loss_bound,
         worst_grad_rel_l2=worst, worst_tensor=worst_name, min_cos=low_cos,
         noise_floor=dict(loss=floor_loss, grad_rel_l2=floor, tensor=floor_name, min_cos=floor_cos),
         vanishing_tensors=len(vanishing), bounds=[max_grad, min_cos], overflow=[card["overflow"], cpu["overflow"]],
         cpu_seconds=cpu["seconds"])
    if not (all(rel_loss[k] < loss_bound[k] for k in rel_loss) and worst < max_grad and low_cos > min_cos):
        raise AssertionError(f"card and CPU Sonata train steps disagree ({phase})")
    if card["overflow"] or cpu["overflow"]:
        raise AssertionError(f"{phase}: overflow {card['overflow']} (card), {cpu['overflow']} (CPU)")


def scratch_path(device, card, work: str):
    """Phase 13's supervised PT-v3m2 run: `semseg-pt-v3m2-0-sonata-scratch.py`
    (PT-v3m2's linear stem, Sonata's encoder widths, a decoder, the ScanNet
    base's block engine) through `main_worker` at phase 10's cuts: 4 steps,
    2 evaluations."""
    data_root = os.path.join(work, "scannet")
    options = dict(TRAINER_OPTIONS, **{"data.train.data_root": data_root, "data.val.data_root": data_root})
    trainer, steps, evals, launches, peak, seconds = _run_config(device, work, SCRATCH_CONFIG, options, "scratch")
    emit("scratch", config=SCRATCH_CONFIG, card=card, seconds=seconds,
         parameters=sum(p.numel() for p in trainer.model.parameters()), steps=len(steps),
         losses=[st["loss"] for st in steps], **_step_times(steps), val_mIoU=evals["mIoU"],
         val_overflow=evals["overflow"], peak_memory_bytes=peak, launches=launches)
    if len(steps) != 4:
        raise AssertionError(f"scratch: expected 4 steps, got {len(steps)}")
    for name in TRAIN_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the PT-v3m2 trainer")


def _run_config(device, work: str, config: str, options: dict, tag: str):
    """`main_worker` of the training CLI on `config` with `options`, launch
    counters set to 0 just before and read just after: (trainer, its steps
    from metrics.jsonl, its evaluation, launches, peak bytes, seconds)."""
    import torch

    from pointcept_tpu_torch.engines import default_config_parser, main_worker
    from pointcept_tpu_torch.ops.kernels import KERNELS

    save = os.path.join(work, tag)
    cfg = default_config_parser(os.path.join(ROOT, config), dict(options, save_path=save))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = _quiet(lambda: main_worker(cfg), os.path.join(work, "trainer.log"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    steps = [dict(epoch=r["epoch"], loss=r["loss"], batch_time_ms=r["batch_time"] * 1e3,
                  data_time_ms=r["data_time"] * 1e3, overflow=r["pool_overflow"] + r["block_overflow"])
             for r in _metrics(save)]
    evals = trainer.comm_info["eval_result"]
    metric = evals["mIoU"] if "mIoU" in evals else evals["mAP"]  # semantic or instance segmentation
    if len(steps) < 2 or not all(math.isfinite(st["loss"]) for st in steps):
        raise AssertionError(f"{tag}: expected finite losses of at least 2 steps, got {[st['loss'] for st in steps]}")
    if any(st["overflow"] for st in steps) or evals["overflow"] or not math.isfinite(metric):
        raise AssertionError(f"{tag}: points overflowed static capacities, or val metric {metric}")
    return trainer, steps, evals, launches, peak, seconds


def _moved(model, reference: dict, prefix: str = "") -> tuple:
    """(names of `model`'s parameters under `prefix` equal to `reference`'s
    tensor of the same name, names that differ); names `reference` lacks
    are left out."""
    same, moved = [], []
    for name, p in model.named_parameters():
        if name.startswith(prefix) and name in reference:
            (same if bool((p.detach().cpu() == reference[name]).all()) else moved).append(name)
    return same, moved


def _write_la_lr(work: str, data_root: str) -> dict:
    """The data-efficient benchmarks' files for phase 10's train scenes, in
    the formats the ports read: the la20 dict (scene -> LA_POINTS labelled
    point indices) as an `np.save` pickle, and the lr1 list, one scene a
    line."""
    import numpy as np

    rng = np.random.RandomState(0)
    la = {}
    for name in sorted(os.listdir(os.path.join(data_root, "train"))):
        n = np.load(os.path.join(data_root, "train", name, "coord.npy"), mmap_mode="r").shape[0]
        la[name] = np.sort(rng.choice(n, LA_POINTS, replace=False))
    la_file, lr_file = os.path.join(work, "points20"), os.path.join(work, "lr1.txt")
    with open(la_file, "wb") as f:
        np.save(f, la)
    with open(lr_file, "w") as f:
        f.write("".join(f"{name}\n" for name in LR_SCENES))
    return dict(la_file=la_file, lr_file=lr_file)


def downstream_path(device, card, work: str):
    """Phase 14: Sonata's downstream configs on phase 13's checkpoint
    (`model_last.pth` of its first run), through the training CLI's
    `main_worker`: the linear probe, the decoder probe, the fine-tune and
    the data-efficient la20 and lr1 fine-tunes; then the linear probe's test
    section through the test CLI's `main_worker`."""
    import numpy as np
    import torch

    data_root = os.path.join(work, "scannet")
    weight = os.path.join(work, "sonata", "model", "model_last.pth")
    ckpt = torch.load(weight, map_location="cpu", weights_only=False)["state_dict"]
    student = {"backbone." + k[len("student.backbone."):]: v for k, v in ckpt.items()
               if k.startswith("student.backbone.")}
    del ckpt
    files = _write_la_lr(work, data_root)
    base = dict(DOWNSTREAM_OPTIONS, weight=weight, **{"data.train.data_root": data_root,
                                                     "data.val.data_root": data_root})
    extra = {"0e0": {"data.train.la_file": files["la_file"]},
             "0e4": {"data.train.lr_file": files["lr_file"], "epoch": 4}}
    emit("downstream_setup", configs=[c for _, c in DOWNSTREAM_CONFIGS], options=dict(base, weight="phase 13"),
         per_config=extra, la_points=LA_POINTS, lr_scenes=list(LR_SCENES))
    summary = {}
    for tag, config in DOWNSTREAM_CONFIGS:
        options = dict(base, **extra.get(tag, {}))
        trainer, steps, evals, launches, peak, seconds = _run_config(device, work, config, options, f"down_{tag}")
        model = trainer.model
        info = trainer.comm_info.get("load_info", {})
        missing, unexpected = info.get("missing", []), info.get("unexpected", [])
        # the probes and fine-tunes miss the seg head alone (the decoder
        # probe its decoder too); the teacher, the SSL heads and the mask
        # token are unexpected
        fresh = ("seg_head.", "backbone.dec.") if tag == "0b" else ("seg_head.",)
        load_ok = (bool(missing) and all(k.startswith(fresh) for k in missing)
                   and {k for k in model.state_dict() if k.startswith(fresh)} == set(missing)
                   and all(k.startswith(("teacher.", "student.mask_head.", "student.unmask_head."))
                           or k == "backbone.embedding.mask_token" for k in unexpected)
                   and any(k.startswith("teacher.") for k in unexpected))
        same, moved = _moved(model, student, "backbone.")
        trainable = [n for n, p in model.named_parameters() if p.requires_grad]
        grouped = sum(len(g["params"]) for g in trainer.optimizer.param_groups)
        row = dict(config=config, card=card, seconds=seconds, steps=len(steps), losses=[st["loss"] for st in steps],
                   **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9, val_mIoU=evals["mIoU"],
                   eval_ms_per_scene=evals["batch_ms"], launches=launches, missing_keys=len(missing),
                   unexpected_keys=len(unexpected), load_ok=load_ok, backbone_unchanged=len(same),
                   backbone_moved=len(moved), trainable=len(trainable), optimizer_tensors=grouped,
                   parameters=sum(p.numel() for p in model.parameters()))
        if tag == "0e0":
            trainer.train_loader.num_workers = 0
            labelled = []
            for i in range(len(trainer.train_loader.dataset)):
                seg = trainer.train_loader.dataset[i]["segment"]
                labelled.append(int((np.asarray(seg) >= 0).sum()))
            row["labelled_points_a_sample"] = labelled
            if not (0 < max(labelled) and max(labelled) <= LA_POINTS):
                raise AssertionError(f"0e0: labelled points a sample {labelled}, expected 1-{LA_POINTS}")
        emit("downstream", tag=tag, **row)
        summary[tag] = row
        if not load_ok:
            raise AssertionError(f"{tag}: loaded keys off: missing {missing[:5]}, unexpected {unexpected[:5]}")
        if tag == "0a":
            # the frozen backbone: as loaded, bit for bit; only the seg head is trained
            if moved or set(trainable) != {"seg_head.weight", "seg_head.bias"} or grouped != 2:
                raise AssertionError(f"0a: backbone tensors moved {moved[:3]}, trainable {trainable[:4]}")
            if launches["patch_attention_bwd"]:
                raise AssertionError("0a: an attention backward ran through the frozen backbone")
        else:
            enc = [n for n in same if not n.startswith("backbone.dec.")]
            if enc:
                raise AssertionError(f"{tag}: {len(enc)} backbone tensors not updated, e.g. {enc[:3]}")
            for name in ("patch_attention", "patch_attention_bwd"):
                if launches[name] == 0:
                    raise AssertionError(f"kernel {name} was not launched by {tag}")
        del trainer, model
        release()
    if not summary["0a"]["peak_memory_bytes"] < summary["0c"]["peak_memory_bytes"]:
        raise AssertionError("the linear probe needed no less memory than the fine-tune")
    probe_tester(device, card, work)


def probe_tester(device, card, work: str):
    """Phase 14's tester: the linear probe config's test section (13 views)
    on the probe's weights and one val scene of PROBE_TESTER_POINTS points;
    the enc_mode backbone takes the per-fragment path (one forward a
    fragment)."""
    test_root = os.path.join(work, "scannet_probe_test")
    raw = write_scannet_scene(test_root, "val", int(PROBE_TEST_SCENE[5:9]), PROBE_TESTER_POINTS)
    # one scene: a loader worker would overlap nothing and take its start
    options = dict(weight=os.path.join(work, "down_0a", "model", "model_last.pth"), seed=0, num_worker=0,
                   **{"data.test.data_root": test_root})
    st = test_scene(device, card, work, "probe_tester", DOWNSTREAM_CONFIGS[0][1], PROBE_TEST_SCENE, raw, options)
    if st["groups"] is not None or st["forwards"] != st["fragments"]:
        raise AssertionError("probe tester: the enc_mode probe did not take the per-fragment path")


def utonia_path(device, card, work: str) -> dict:
    """Phase 15: Utonia's linear probe and fine-tune (PT-v3m3 with RoPE,
    head dim 18) through the training CLI's `main_worker` at full width on
    phase 10's scenes, at phase 14's cuts and ``in_channels=6``; no Utonia
    checkpoint exists, so the loader logs "No weight found" and the weights
    are random (seed 0). Then one small-depth fine-tune step on the card
    against the CPU. Returns the fine-tune's launches of the D = 18
    attention kernels."""
    import torch

    from pointcept_tpu_torch.models import apply_amp_policy, build_model

    data_root = os.path.join(work, "scannet")
    options = dict(DOWNSTREAM_OPTIONS, **UTONIA_OPTIONS, **{"data.train.data_root": data_root,
                                                          "data.val.data_root": data_root})
    emit("utonia_setup", configs=[c for _, c in UTONIA_CONFIGS], options=options)
    result = {}
    for tag, config in UTONIA_CONFIGS:
        trainer, steps, evals, launches, peak, seconds = _run_config(device, work, config, options, f"utonia_{tag}")
        cfg = trainer.cfg
        model = trainer.model
        initial = build_model(apply_amp_policy(dict(cfg.model), cfg.enable_amp), device="cpu",
                              generator=torch.Generator().manual_seed(cfg.shared_seed))
        reference = {n: p.detach() for n, p in initial.named_parameters()}
        del initial
        same, moved = _moved(model, reference)
        bb = cfg.model.backbone
        blocks, n = sum(bb.enc_depths), len(steps)
        # every val batch's forward attends once a block
        fwd_per_step = (launches["patch_attention"] - len(evals["batch_ms"]) * blocks) / n
        bwd_per_step = launches["patch_attention_bwd"] / n
        d = {c // h for c, h in zip(bb.enc_channels, bb.enc_num_head)}
        emit("utonia", tag=tag, config=config, card=card, seconds=seconds, head_dims=sorted(d),
             rope_base=bb.rope_base, steps=n, losses=[st["loss"] for st in steps], **_step_times(steps),
             peak_memory_bytes=peak, peak_gb=peak / 1e9, val_mIoU=evals["mIoU"],
             eval_ms_per_scene=evals["batch_ms"], launches=launches, attention_fwd_per_step=fwd_per_step,
             attention_bwd_per_step=bwd_per_step, unchanged_parameters=len(same), moved_parameters=len(moved),
             parameters=sum(p.numel() for p in model.parameters()))
        if d != {18}:
            raise AssertionError(f"utonia: head dims {d}")
        if fwd_per_step != blocks or bwd_per_step != (blocks if tag == "0c" else 0):
            raise AssertionError(f"utonia {tag}: {fwd_per_step} attention forwards and {bwd_per_step} "
                                 f"backwards a step, {blocks} blocks")
        if tag == "0a" and any(not n_.startswith("seg_head.") for n_ in moved):
            raise AssertionError(f"utonia 0a: frozen backbone tensors moved, e.g. {moved[:3]}")
        if tag == "0c" and [n_ for n_ in same if n_ != "backbone.embedding.mask_token"]:
            raise AssertionError(f"utonia 0c: tensors not updated, e.g. {same[:3]}")
        result[tag] = launches
        del trainer, model
        release()

    # one small-depth fine-tune step (f32) on the card against the CPU
    card_vs_cpu_train(device, **utonia_cvct())
    return result["0c"]


def utonia_cvct() -> dict:
    """Phase 15's `card_vs_cpu_train` arguments: one small-depth step of the
    fine-tune config (f32)."""
    from pointcept_tpu_torch.utils.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, UTONIA_CONFIGS[1][1]))
    small = dict(cfg.model, backbone=dict(cfg.model.backbone, in_channels=6, enc_depths=(1,) * 5, drop_path=0.0,
                                          pool_capacity_factors=(0.5,) * 4))
    recipe = dict(optimizer=dict(cfg.optimizer), param_dicts=cfg.param_dicts, scheduler=dict(cfg.scheduler))
    return dict(cases=[(False, small, recipe)], phase="utonia_card_vs_cpu_train")


def _run_checked(device, work: str, config: str, options: dict, tag: str, kernels=()):
    """`_run_config`, then: 4 steps, the head as wide as the config's
    classes, each of `kernels` launched."""
    trainer, steps, evals, launches, peak, seconds = _run_config(device, work, config, options, tag)
    classes = trainer.cfg.data.num_classes
    if len(steps) != 4:
        raise AssertionError(f"{tag}: expected 4 steps, got {len(steps)}")
    head = getattr(trainer.model, "seg_head", None)
    if head is not None and head.out_features != classes:
        raise AssertionError(f"{tag}: a head of {head.out_features} classes for {classes}")
    for name in kernels:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by {tag}")
    return trainer, steps, evals, launches, peak, seconds


def scannet200_path(device, card, work: str):
    """Phase 16: ScanNet200's PTv3 config through the training CLI's
    `main_worker` on phase 10's scenes (their segment200.npy), then its test
    section through the test CLI's `main_worker` on one val scene of
    PROBE_TEST_POINTS raw points: the grouped path, 200-way preds, and the
    benchmark submission refused with the list it lacks."""
    import numpy as np
    import torch

    data_root = os.path.join(work, "scannet")
    options = dict(DOWNSTREAM_OPTIONS, **{"data.train.data_root": data_root, "data.val.data_root": data_root})
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, SCANNET200_CONFIG, options, "s200",
                                                                  TRAIN_KERNELS)
    emit("scannet200", config=SCANNET200_CONFIG, options=options, card=card, seconds=seconds,
         parameters=sum(p.numel() for p in trainer.model.parameters()), classes=trainer.cfg.data.num_classes,
         steps=len(steps), losses=[st["loss"] for st in steps], **_step_times(steps), peak_memory_bytes=peak,
         peak_gb=peak / 1e9, val_mIoU=evals["mIoU"], eval_ms_per_scene=evals["batch_ms"], launches=launches)
    del trainer
    release()

    test_root = os.path.join(work, "scannet200_test")
    raw = write_scannet_scene(test_root, "val", int(PROBE_TEST_SCENE[5:9]), PROBE_TEST_POINTS)
    options = dict(TESTER_OPTIONS, weight=os.path.join(work, "s200", "model", "model_last.pth"), num_worker=0,
                   **{"data.test.data_root": test_root})
    refused = {}

    def submission(tester, pred):
        try:
            tester.write_submission(os.path.join(work, "s200_test"), PROBE_TEST_SCENE, np.argmax(pred, axis=-1))
        except NotImplementedError as e:
            refused["message"] = str(e)

    st = test_scene(device, card, work, "s200_test", SCANNET200_CONFIG, PROBE_TEST_SCENE, raw, options,
                    after=submission)
    emit("scannet200_submission", refused=bool(refused), message=refused.get("message"))
    if st["groups"] is None:
        raise AssertionError("ScanNet200 tester: the PTv3 config did not take the grouped path")
    if "200 label ids" not in refused.get("message", ""):
        raise AssertionError(f"ScanNet200 submission not refused with the missing list: {refused}")


def _box_faces(lo, hi, bottom: bool = False) -> list:
    """The faces of an axis-aligned box as (origin, u, v, normal): its top,
    its four sides and, with `bottom`, its underside."""
    import numpy as np

    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    d = hi - lo
    ex, ey, ez = np.diag(d)
    faces = [(lo + ez, ex, ey, (0, 0, 1)), (lo, ex, ez, (0, -1, 0)), (lo + ey, ex, ez, (0, 1, 0)),
             (lo, ey, ez, (-1, 0, 0)), (lo + ex, ey, ez, (1, 0, 0))]
    if bottom:
        faces.append((lo, ex, ey, (0, 0, -1)))
    return faces


def write_s3dis_room(path: str, seed: int, points: int = S3DIS_ROOM_POINTS) -> dict:
    """A synthetic office in S3DIS's preprocessed layout (`coord`, `color` as
    float 0-255, `normal`, `segment` of S3DIS's 13 classes, `instance`, one
    directory a room): floor, ceiling and four walls of a 5-7 x 4-6 x
    2.8-3.2 m room, a door, a window and a board on the walls, a beam and a
    column, tables with chairs, a bookcase, a sofa and clutter as box
    surfaces, each a separate instance; `points` points spread by area with
    2 mm of noise. Returns its points and its voxel counts at 2 and 4 cm
    after the configs' CenterShift, as their GridSample makes them."""
    import numpy as np

    from pointcept_tpu_torch.datasets.transform import CenterShift, GridSample

    rng = np.random.RandomState(seed)
    lx, ly, lz = rng.uniform(5.0, 7.0), rng.uniform(4.0, 6.0), rng.uniform(2.8, 3.2)
    cls = {name: i for i, name in enumerate(S3DIS_CLASSES)}
    patches = [((0, 0, 0), (lx, 0, 0), (0, ly, 0), (0, 0, 1), cls["floor"]),
               ((0, 0, lz), (lx, 0, 0), (0, ly, 0), (0, 0, -1), cls["ceiling"]),
               ((0, 0, 0), (lx, 0, 0), (0, 0, lz), (0, 1, 0), cls["wall"]),
               ((0, ly, 0), (lx, 0, 0), (0, 0, lz), (0, -1, 0), cls["wall"]),
               ((0, 0, 0), (0, ly, 0), (0, 0, lz), (1, 0, 0), cls["wall"]),
               ((lx, 0, 0), (0, ly, 0), (0, 0, lz), (-1, 0, 0), cls["wall"]),
               ((0.8, 0.01, 0), (0.9, 0, 0), (0, 0, 2.1), (0, 1, 0), cls["door"]),
               ((lx - 2.5, ly - 0.01, 0.9), (1.6, 0, 0), (0, 0, 1.3), (0, -1, 0), cls["window"]),
               ((0.01, 1.0, 1.0), (0, 2.0, 0), (0, 0, 1.1), (1, 0, 0), cls["board"])]
    boxes = [((0, ly / 2 - 0.15, lz - 0.4), (lx, ly / 2 + 0.15, lz), "beam"),
             ((lx - 0.4, 0, 0), (lx, 0.4, lz), "column"),
             ((lx - 0.45, 1.0, 0), (lx - 0.01, 2.8, 2.0), "bookcase"),
             ((1.5, ly - 1.0, 0), (3.3, ly - 0.1, 0.8), "sofa")]
    for t in range(int(rng.randint(2, 4))):
        x0, y0 = 1.6 + 1.4 * t, rng.uniform(1.2, ly - 2.4)
        boxes.append(((x0, y0, 0.72), (x0 + 1.2, y0 + 0.7, 0.76), "table"))
        for c in range(2):
            cx = x0 + 0.2 + 0.5 * c
            boxes.append(((cx, y0 - 0.55, 0.0), (cx + 0.45, y0 - 0.1, 0.45), "chair"))
    for _ in range(int(rng.randint(4, 8))):
        x0, y0 = rng.uniform(0.5, lx - 0.8), rng.uniform(0.5, ly - 0.8)
        size = rng.uniform(0.15, 0.5, 3)
        boxes.append(((x0, y0, 0.0), (x0 + size[0], y0 + size[1], size[2]), "clutter"))
    for lo, hi, name in boxes:
        patches += [(o, u, v, n, cls[name]) for o, u, v, n in _box_faces(lo, hi, bottom=name in ("beam", "table"))]
    area = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v, _, _ in patches])
    counts = rng.multinomial(points, area / area.sum())
    owner = np.repeat(np.arange(len(patches)), counts)
    origin, u, v, normal = (np.array([p[i] for p in patches], np.float64)[owner] for i in range(4))
    st = rng.rand(points, 2)
    coord = origin + st[:, :1] * u + st[:, 1:] * v + rng.normal(0, 0.002, (points, 3))
    label = np.array([p[4] for p in patches])[owner]
    base = rng.uniform(40, 215, (len(S3DIS_CLASSES), 3))
    color = np.clip(base[label] + rng.normal(0, 12, (points, 3)), 0, 255)
    os.makedirs(path)
    for name, value in (("coord", coord.astype(np.float32)), ("color", color.astype(np.float32)),
                        ("normal", normal.astype(np.float32)), ("segment", label.astype(np.int16)),
                        ("instance", owner.astype(np.int16))):
        np.save(os.path.join(path, f"{name}.npy"), value)
    shifted = CenterShift(apply_z=True)(dict(coord=coord.astype(np.float32)))["coord"]
    voxels = {f"{round(g * 100)}cm": len(GridSample(grid_size=g)._voxel_runs(shifted)[3]) for g in (0.02, 0.04)}
    return dict(points=points, **voxels)


def s3dis_path(device, card, work: str):
    """Phase 17: the S3DIS SpUNet config through the training CLI's
    `main_worker` on synthetic offices in S3DIS's layout: 4 steps and one
    evaluation, each step's lr against PolyLR's formula; then its one-view
    test section on the Area_5 room at a `point_capacity_test` set from the
    room, its `record.npz` read by `tools/test_s3dis_6fold.py`; then the
    tester refusing a room over its static capacities. Returns the rooms'
    points and voxel counts."""
    import torch

    from pointcept_tpu_torch.engines import default_config_parser
    from pointcept_tpu_torch.utils.config import Config

    root = os.path.join(work, "s3dis")
    rooms = {}
    for a, (area, n) in enumerate(S3DIS_ROOMS.items()):
        for i in range(n):
            rooms[f"{area}/office_{i + 1}"] = write_s3dis_room(os.path.join(root, area, f"office_{i + 1}"),
                                                               100 + 10 * a + i)
    val = rooms["Area_5/office_1"]
    cfg = Config.fromfile(os.path.join(ROOT, S3DIS_CONFIG))
    options = dict(S3DIS_OPTIONS, **{"data.train.data_root": root, "data.val.data_root": root})
    emit("s3dis_setup", config=S3DIS_CONFIG, options=options, rooms=rooms,
         point_capacity_val=cfg.point_capacity_val)
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, S3DIS_CONFIG, options, "s3dis")
    rows = _metrics(os.path.join(work, "s3dis"))
    total = len(rows)
    base_lr = trainer.cfg.optimizer.lr
    want = [base_lr * (1 - i / (total + 1)) ** 0.9 for i in range(total)]
    lr_err = max(abs(r["lr"] - w) / w for r, w in zip(rows, want))
    emit("s3dis", card=card, seconds=seconds, parameters=sum(p.numel() for p in trainer.model.parameters()),
         steps=len(steps), losses=[st["loss"] for st in steps], lr=[r["lr"] for r in rows], lr_formula=want,
         lr_max_rel_err=lr_err, **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9,
         val_mIoU=evals["mIoU"], eval_ms_per_scene=evals["batch_ms"], launches=launches,
         scheduler=type(trainer.scheduler).__name__)
    if lr_err > 1e-12:
        raise AssertionError(f"s3dis: the lr of the steps {[r['lr'] for r in rows]} is not PolyLR's {want}")
    if val["4cm"] > cfg.point_capacity_val:
        raise AssertionError(f"s3dis: the val room's {val['4cm']} voxels exceed point_capacity_val")
    del trainer
    release()

    # the test section: the whole room is each fragment (crop None)
    capacity = -(-val["4cm"] // 4096) * 4096 + 4096
    options = dict(weight=os.path.join(work, "s3dis", "model", "model_last.pth"), seed=0, num_worker=0,
                   point_capacity_test=capacity, **{"data.test.data_root": root})
    st = test_scene(device, card, work, "s3dis_test", S3DIS_CONFIG, "office_1", val["points"], options, kernels=())
    tool = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "test_s3dis_6fold.py"), "--record-root",
                           os.path.join(work, "s3dis_test")], cwd=ROOT, capture_output=True, text=True, timeout=120)
    emit("s3dis_6fold", returncode=tool.returncode, stdout=tool.stdout.splitlines()[:2],
         point_capacity_test=capacity, room=val, fragments=st["fragments"])
    if tool.returncode != 0 or "6-fold result" not in tool.stdout:
        print(tool.stderr[-2000:], file=sys.stderr)
        raise AssertionError("tools/test_s3dis_6fold.py could not read the tester's record.npz")

    # a room over the static capacities: the tester refuses it, at the
    # fragment's size and at the pooled levels' drops
    from pointcept_tpu_torch.engines.test import main_worker

    refusals = {}
    for tag, over in (("fragment", dict(point_capacity_test=val["4cm"] - 1024)),
                      ("pooling", {"model.backbone.pool_capacity_factor": 0.15})):
        cfg = default_config_parser(os.path.join(ROOT, S3DIS_CONFIG),
                                    {**options, "save_path": os.path.join(work, f"s3dis_over_{tag}"), **over})
        try:
            # meant to raise: its log lines go to the log, and its tail is not printed
            with open(os.path.join(work, "tester.log"), "a") as log, contextlib.redirect_stdout(log):
                main_worker(cfg)
        except (ValueError, RuntimeError) as e:
            refusals[tag] = f"{type(e).__name__}: {e}"
    emit("s3dis_over_capacity", refusals=refusals)
    if "point_capacity_test" not in refusals.get("fragment", "") or \
            "eval_overflow_tolerance" not in refusals.get("pooling", ""):
        raise AssertionError(f"s3dis: a room over capacity was not refused: {refusals}")
    return rooms


def scannetpp_path(device, card, work: str):
    """Phase 18: ScanNet++'s PTv3 config through the training CLI's
    `main_worker` on phase 10's scenes in ScanNet++'s layout: coord, color,
    normal and instance linked, and a 1-d `segment.npy` of 100 classes."""
    import numpy as np
    import torch

    src, root = os.path.join(work, "scannet"), os.path.join(work, "scannetpp")
    for split in ("train", "val"):
        for name in sorted(os.listdir(os.path.join(src, split))):
            d = os.path.join(root, split, f"{int(name[5:9]):02x}c4b1ad05")
            os.makedirs(d)
            for asset in ("coord", "color", "normal", "instance"):
                os.symlink(os.path.join(src, split, name, f"{asset}.npy"), os.path.join(d, f"{asset}.npy"))
            seg = np.load(os.path.join(src, split, name, "segment20.npy")).astype(np.int32)
            inst = np.load(os.path.join(src, split, name, "instance.npy")).astype(np.int32)
            np.save(os.path.join(d, "segment.npy"), np.where(seg >= 0, seg * 5 + inst % 5, -1).astype(np.int16))
    options = dict(DOWNSTREAM_OPTIONS, **{"data.train.data_root": root, "data.val.data_root": root})
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, SCANNETPP_CONFIG, options, "spp",
                                                                  TRAIN_KERNELS)
    emit("scannetpp", config=SCANNETPP_CONFIG, options=options, card=card, seconds=seconds,
         classes=trainer.cfg.data.num_classes, steps=len(steps), losses=[st["loss"] for st in steps],
         **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9, val_mIoU=evals["mIoU"],
         eval_ms_per_scene=evals["batch_ms"], launches=launches)
    del trainer
    release()


def lora_path(device, card, work: str):
    """Phase 19: Concerto-large's LoRA fine-tune through the training CLI's
    `main_worker` on phase 10's scenes, from a random PT-v3m2 encoder at the
    large widths saved under ``student.backbone.`` in the reference's
    checkpoint layout: the loaded keys, the frozen encoder bit for bit,
    the adapters and the head moved, the attention launches a step; then
    one small-depth LoRA step (f32, ``lora_b`` drawn nonzero so that every
    adapter has a gradient) on the card against the CPU."""
    import torch

    from pointcept_tpu_torch.models import apply_amp_policy, build_model
    from pointcept_tpu_torch.utils.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, LORA_CONFIG))
    cfg.merge_from_dict(LORA_OPTIONS)
    encoder = dict(cfg.model.backbone)
    weight = os.path.join(work, "concerto_large_encoder.pth")
    pretrained = build_model(encoder, device="cpu", generator=torch.Generator().manual_seed(11))
    ckpt = {"backbone." + k: v for k, v in pretrained.state_dict().items()}
    torch.save({"state_dict": {"student." + k: v for k, v in ckpt.items()}}, weight)
    del pretrained
    data_root = os.path.join(work, "scannet")
    options = dict(DOWNSTREAM_OPTIONS, weight=weight, **LORA_OPTIONS,
                   **{"data.train.data_root": data_root, "data.val.data_root": data_root})
    emit("lora_setup", config=LORA_CONFIG, options=dict(options, weight="random encoder, seed 11"),
         encoder_tensors=len(ckpt), lora_rank=cfg.model.lora_rank)
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, LORA_CONFIG, options, "lora")
    model, run_cfg = trainer.model, trainer.cfg
    info = trainer.comm_info.get("load_info", {})
    adapters = {n for n in model.state_dict() if n.endswith((".lora_a", ".lora_b"))}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    head = {"seg_head.weight", "seg_head.bias"}
    initial = build_model(apply_amp_policy(dict(run_cfg.model), run_cfg.enable_amp), device="cpu",
                          generator=torch.Generator().manual_seed(run_cfg.shared_seed))
    fresh = {n: p.detach() for n, p in initial.named_parameters() if n in adapters | head}
    del initial
    frozen_same, frozen_moved = _moved(model, ckpt, "backbone.")
    _, trained_moved = _moved(model, fresh)
    blocks, n = sum(run_cfg.model.backbone.enc_depths), len(steps)
    fwd_per_step = (launches["patch_attention"] - len(evals["batch_ms"]) * blocks) / n
    bwd_per_step = launches["patch_attention_bwd"] / n
    grouped = sum(len(g["params"]) for g in trainer.optimizer.param_groups)
    emit("lora", config=LORA_CONFIG, card=card, seconds=seconds, steps=n, losses=[st["loss"] for st in steps],
         **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9, val_mIoU=evals["mIoU"],
         eval_ms_per_scene=evals["batch_ms"], launches=launches, attention_fwd_per_step=fwd_per_step,
         attention_bwd_per_step=bwd_per_step, missing_keys=len(info.get("missing", [])),
         unexpected_keys=len(info.get("unexpected", [])), adapters=len(adapters), trainable=len(trainable),
         optimizer_tensors=grouped, frozen_unchanged=len(frozen_same), frozen_moved=len(frozen_moved),
         trained_moved=len(trained_moved), parameters=sum(p.numel() for p in model.parameters()),
         trainable_parameters=sum(p.numel() for p in model.parameters() if p.requires_grad))
    if set(info.get("missing", [])) != adapters | head or info.get("unexpected"):
        raise AssertionError(f"lora: loaded keys off: missing {sorted(info.get('missing', []))[:4]}, "
                             f"unexpected {info.get('unexpected', [])[:4]}")
    if trainable != adapters | head or grouped != len(trainable) or len(adapters) != 2 * blocks:
        raise AssertionError(f"lora: trainable tensors {sorted(trainable - adapters)[:4]}, {len(adapters)} adapters")
    if frozen_moved or len(frozen_same) != len([k for k in ckpt if k in dict(model.named_parameters())]):
        raise AssertionError(f"lora: frozen encoder tensors moved, e.g. {frozen_moved[:3]}")
    if set(trained_moved) != adapters | head:
        raise AssertionError(f"lora: trainable tensors not updated: {sorted(adapters | head - set(trained_moved))[:4]}")
    if fwd_per_step != blocks or bwd_per_step != blocks:
        raise AssertionError(f"lora: {fwd_per_step} attention forwards and {bwd_per_step} backwards a step, "
                             f"{blocks} blocks")
    del trainer, model
    release()

    card_vs_cpu_train(device, **lora_cvct())


def _lora_adapters_at_work(model) -> None:
    """`lora_b` drawn N(0, 0.5) (seed 12), so that every adapter has a gradient."""
    import torch

    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)


def lora_cvct() -> dict:
    """Phase 19's `card_vs_cpu_train` arguments: one small-depth LoRA step
    (f32) with the adapters at work."""
    from pointcept_tpu_torch.utils.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, LORA_CONFIG))
    cfg.merge_from_dict(LORA_OPTIONS)
    small = dict(cfg.model, backbone=dict(cfg.model.backbone, enc_depths=(1,) * 5, drop_path=0.0,
                                          pool_capacity_factors=(0.5,) * 4))
    recipe = dict(optimizer=dict(cfg.optimizer), param_dicts=cfg.param_dicts, scheduler=dict(cfg.scheduler))
    return dict(cases=[(False, small, recipe)], phase="lora_card_vs_cpu_train", init=_lora_adapters_at_work)


def street(seed: int, height: float) -> dict:
    """A street of primitives around a sensor at the origin, `height` above
    the ground: facades of 6-20 m on both sides at 10-52 m, blocks across the
    street at 42-75 m with the street open between them, a far block at
    106-114 m (past 102.4 m, the extent of 2,048 cells of 5 cm), cars in
    four lanes (some moving), poles, trees (trunks and crowns) and people on
    the sidewalks. Boxes (lo, hi, class, instance id), crowns as spheres."""
    import numpy as np

    rng = np.random.RandomState(seed)
    g = -height
    boxes, spheres = [], []
    for side in (-1.0, 1.0):
        x = -75.0 + rng.uniform(0, 5)
        while x < 75.0:
            length, near, depth, top = rng.uniform(8, 25), rng.uniform(10, 22), rng.uniform(8, 30), rng.uniform(6, 20)
            y0, y1 = sorted((side * near, side * (near + depth)))
            boxes.append(((x, y0, g), (x + length, y1, g + top), "building", 0))
            x += length + rng.uniform(2, 8)
        near = rng.uniform(42, 60)
        for y0, y1 in ((-60.0, -11.0), (11.0, 60.0)):
            boxes.append(((side * near if side > 0 else side * (near + 15), y0, g),
                          (side * (near + 15) if side > 0 else side * near, y1, g + rng.uniform(8, 25)),
                          "building", 0))
    boxes.append(((106.0, -30.0, g), (114.0, 30.0, g + 30.0), "building", 0))
    inst = 1
    for _ in range(14):
        x, lane = rng.uniform(-38, 38), rng.choice([-5.3, -2.0, 2.0, 5.3])
        cls = "moving_car" if abs(lane) < 3 and rng.rand() < 0.5 else "car"
        boxes.append(((x, lane - 0.9, g), (x + rng.uniform(4.0, 4.8), lane + 0.9, g + rng.uniform(1.4, 1.7)), cls,
                      inst))
        inst += 1
    for side in (-1.0, 1.0):
        for x in np.arange(-36.0, 37.0, 12.0) + rng.uniform(-2, 2):
            boxes.append(((x - 0.12, side * 7.3 - 0.12, g), (x + 0.12, side * 7.3 + 0.12, g + 7.0), "pole", 0))
        for x in np.arange(-40.0, 41.0, 6.0) + rng.uniform(-2, 2):
            y, r = side * rng.uniform(8.0, 9.5), rng.uniform(1.4, 2.4)
            boxes.append(((x - 0.2, y - 0.2, g), (x + 0.2, y + 0.2, g + 2.5), "trunk", 0))
            spheres.append(((x, y, g + 2.5 + 0.7 * r), r))
        for _ in range(3):
            x, y = rng.uniform(-25, 25), side * rng.uniform(4.6, 6.6)
            boxes.append(((x - 0.25, y - 0.25, g), (x + 0.25, y + 0.25, g + 1.75), "person", inst))
            inst += 1
    return dict(lo=np.array([b[0] for b in boxes]), hi=np.array([b[1] for b in boxes]),
                box_class=np.array([b[2] for b in boxes], dtype=object),
                box_instance=np.array([b[3] for b in boxes]), center=np.array([c for c, _ in spheres]),
                radius=np.array([r for _, r in spheres]), ground=g)


def _ground_class(x, y):
    """Road (its centre line dashed as lane marking), curb, sidewalk, terrain
    by the distance from the street's axis."""
    import numpy as np

    ay = np.abs(y)
    cls = np.full(x.shape, "terrain", dtype=object)
    cls[ay < 7.0] = "sidewalk"
    cls[(ay >= 4.0) & (ay < 4.15)] = "curb"
    cls[ay < 4.0] = "road"
    cls[(ay < 0.12) & (np.floor(x / 3.0) % 2 == 0)] = "lane"
    return cls


def _cast(scene: dict, dirs, max_range: float, chunk: int = 4096):
    """The nearest and the next hit of each ray from the origin within
    `max_range`: (t1, primitive 1, t2, primitive 2), primitives numbered
    boxes, spheres, then the ground; t inf where none."""
    import numpy as np

    n = len(dirs)
    t1, t2, p1, p2 = np.full(n, np.inf), np.full(n, np.inf), np.full(n, -1), np.full(n, -1)
    lo, hi = scene["lo"].astype(np.float32), scene["hi"].astype(np.float32)
    center = scene["center"].astype(np.float32)
    c2 = (center ** 2).sum(1) - scene["radius"].astype(np.float32) ** 2
    for a in range(0, n, chunk):
        d = dirs[a:a + chunk].astype(np.float32)
        inv = 1.0 / np.where(d == 0, np.float32(1e-12), d)
        ta, tb = lo[None] * inv[:, None], hi[None] * inv[:, None]
        tmin = np.minimum(ta, tb).max(axis=2)
        tmax = np.maximum(ta, tb).min(axis=2)
        t_box = np.where((tmax >= tmin) & (tmin > 0.05), tmin, np.inf)
        dc = d @ center.T
        disc = dc ** 2 - c2[None]
        t_sph = np.where(disc > 0, dc - np.sqrt(np.maximum(disc, 0)), np.inf)
        t_sph = np.where(t_sph > 0.05, t_sph, np.inf)
        down = d[:, 2] < 0
        t_gnd = np.where(down, scene["ground"] / np.where(down, d[:, 2], -1.0), np.inf)
        t = np.concatenate([t_box, t_sph, t_gnd[:, None].astype(np.float32)], axis=1)
        t = np.where(t <= max_range, t, np.inf)
        rows = np.arange(len(d))
        first = t.argmin(axis=1)
        t1[a:a + chunk], p1[a:a + chunk] = t[rows, first], first
        t[rows, first] = np.inf
        second = t.argmin(axis=1)
        t2[a:a + chunk], p2[a:a + chunk] = t[rows, second], second
    return t1, p1, t2, p2


def lidar_scan(sensor: str, seed: int) -> dict:
    """One scan of `sensor` (a key of LIDARS) in the street of `seed`: the
    beams evenly over the elevation span, the azimuth steps of a turn from a
    random phase, 2% of the rays lost, 1.5 cm range noise; two-return
    sensors add the return behind each crown hit (foliage lets part of the
    beam through). Returns coord [N, 3] float32, strength in [0, 1] (the
    class's reflectivity, falling with range), the dataset's raw label ids
    (1% of them the unlabelled id), instance ids and the ring of each
    point."""
    import numpy as np

    spec = LIDARS[sensor]
    rng = np.random.RandomState(seed + 7919)
    sc = street(seed, spec["height"])
    el = np.deg2rad(np.linspace(spec["elevation"][0], spec["elevation"][1], spec["beams"]))
    az = np.linspace(0, 2 * np.pi, spec["steps"], endpoint=False) + rng.uniform(0, 2 * np.pi / spec["steps"])
    e, a = np.meshgrid(el, az, indexing="ij")
    dirs = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1).reshape(-1, 3)
    ring = np.repeat(np.arange(spec["beams"]), spec["steps"])
    t1, p1, t2, p2 = _cast(sc, dirs, spec["max_range"])
    nb, ns = len(sc["lo"]), len(sc["radius"])
    keep = np.isfinite(t1) & (rng.rand(len(t1)) > 0.02)
    t, p, rays = [t1[keep]], [p1[keep]], [np.nonzero(keep)[0]]
    if spec["returns"] == 2:
        second = keep & np.isfinite(t2) & (p1 >= nb) & (p1 < nb + ns)
        t, p, rays = t + [t2[second]], p + [p2[second]], rays + [np.nonzero(second)[0]]
    t, p, rays = np.concatenate(t), np.concatenate(p), np.concatenate(rays)
    t = t + rng.normal(0, 0.015, t.shape)
    coord = (dirs[rays] * t[:, None]).astype(np.float32)
    cls = np.full(len(p), "vegetation", dtype=object)
    box = p < nb
    cls[box] = sc["box_class"][p[box]]
    ground = p == nb + ns
    cls[ground] = _ground_class(coord[ground, 0], coord[ground, 1])
    reflectivity = np.array([REFLECTIVITY[c] for c in cls])
    strength = np.clip(reflectivity * (1 - t / (2 * spec["max_range"])) + rng.normal(0, 0.03, len(t)), 0, 1)
    labels = LIDAR_LABELS[sensor]
    raw = np.array([labels[c] for c in cls], dtype=np.int64)
    raw[rng.rand(len(raw)) < 0.01] = labels["unlabeled"]
    return dict(coord=coord, strength=strength.astype(np.float32), raw=raw,
                instance=np.where(box, sc["box_instance"][np.where(box, p, 0)], 0), ring=ring[rays])


def lidar_scans(sensor: str, seeds) -> list:
    """`lidar_scan` of each seed, four at a time (numpy frees the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(lambda seed: lidar_scan(sensor, seed), seeds))


def write_kitti(root: str, frames: dict, labelled=("00", "01", "08")) -> dict:
    """HDL-64E scans in SemanticKITTI's layout: ``dataset/sequences/<seq>/
    velodyne/<frame>.bin`` (float32 x, y, z, remission) and, for the
    `labelled` sequences, ``labels/<frame>.label`` (uint32: instance << 16 |
    semantic id). `frames`: sequence -> street seeds. Returns the points of
    each scan by name."""
    import numpy as np

    sizes = {}
    for seq, seeds in frames.items():
        base = os.path.join(root, "dataset", "sequences", seq)
        os.makedirs(os.path.join(base, "velodyne"))
        if seq in labelled:
            os.makedirs(os.path.join(base, "labels"))
        for i, sc in enumerate(lidar_scans("kitti", seeds)):
            np.concatenate([sc["coord"], sc["strength"][:, None]], 1).astype(np.float32).tofile(
                os.path.join(base, "velodyne", f"{i:06d}.bin"))
            if seq in labelled:
                ((sc["instance"].astype(np.uint32) << 16) | sc["raw"].astype(np.uint32)).tofile(
                    os.path.join(base, "labels", f"{i:06d}.label"))
            sizes[f"{seq}_{i:06d}"] = len(sc["coord"])
    return sizes


def write_nuscenes(root: str, splits: dict, sweeps: int = 10) -> dict:
    """HDL-32E sweeps in nuScenes' info layout: ``raw/samples/LIDAR_TOP/
    <name>.pcd.bin`` (float32 x, y, z, intensity 0-255, ring), lidarseg
    labels ``raw/lidarseg/v1.0-trainval/<token>_lidarseg.bin`` (uint8 of
    the 32 categories; none for the test split) and
    ``info/nuscenes_infos_{sweeps}sweeps_{split}.pkl``. `splits`: split ->
    street seeds. Returns the points of each sweep by name."""
    import pickle

    import numpy as np

    sizes = {}
    for sub in ("raw/samples/LIDAR_TOP", "raw/lidarseg/v1.0-trainval", "info"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for split, seeds in splits.items():
        infos = []
        for seed, sc in zip(seeds, lidar_scans("nuscenes", seeds)):
            name = f"n008-2018-08-01-15-16-36-0400__LIDAR_TOP__{1533151603547590 + seed}"
            token = f"{seed:032x}"
            lidar_path = f"samples/LIDAR_TOP/{name}.pcd.bin"
            np.concatenate([sc["coord"], sc["strength"][:, None] * 255, sc["ring"][:, None]], 1).astype(
                np.float32).tofile(os.path.join(root, "raw", lidar_path))
            info = dict(lidar_path=lidar_path, lidar_token=token, token=f"{seed + 1:032x}")
            if split != "test":
                info["gt_segment_path"] = f"lidarseg/v1.0-trainval/{token}_lidarseg.bin"
                sc["raw"].astype(np.uint8).tofile(os.path.join(root, "raw", info["gt_segment_path"]))
            infos.append(info)
            sizes[name] = len(sc["coord"])
        with open(os.path.join(root, "info", f"nuscenes_infos_{sweeps}sweeps_{split}.pkl"), "wb") as f:
            pickle.dump(infos, f)
    return sizes


def write_waymo(root: str, splits: dict) -> dict:
    """Two-return top-lidar frames in the Waymo preprocessing's layout:
    ``<split>/<segment>/<frame>/{coord,strength,segment}.npy`` (segment
    0-22, 0 undefined). `splits`: split -> street seeds, one frame of a
    segment each. Returns the points of each frame by name."""
    import numpy as np

    sizes = {}
    for split, seeds in splits.items():
        for seed, sc in zip(seeds, lidar_scans("waymo", seeds)):
            segment = f"segment-{10017090168044687777 + seed}_6380_000_6400_000"
            d = os.path.join(root, split, segment, "1550083467346370")
            os.makedirs(d)
            np.save(os.path.join(d, "coord.npy"), sc["coord"])
            np.save(os.path.join(d, "strength.npy"), sc["strength"][:, None])
            np.save(os.path.join(d, "segment.npy"), sc["raw"].astype(np.int32))
            sizes[f"{segment}_1550083467346370"] = len(sc["coord"])
    return sizes


def _pool_chain(capacity: int, factors) -> list:
    """PT-v3's static pooled capacities (`_pooled_capacity`) down the levels."""
    caps, cap = [], capacity
    for f in factors:
        cap = -(-max(math.ceil(cap * f), 128) // 128) * 128
        caps.append(cap)
    return caps


def outdoor_geometry(device, backbone, cfg, capacity: int, own_factors) -> dict:
    """The PT-v3 `backbone`'s geometry on two scans (or rooms) of the
    config's train pipeline (its first two samples, numpy and python seeded
    0), as the
    train forward builds it with every order encoded: the depth the batch
    serializes at, the grid's bits, each pooled level's clusters against its
    capacity at the run's factors and at the config's own (`own_factors`),
    the points dropped, and the patches of any stage and order whose rows
    hold points of both scans."""
    import random

    import numpy as np
    import torch

    from pointcept_tpu_torch.datasets import build_dataset, point_collate_fn
    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models.point_transformer_v3.point_transformer_v3 import pooling_geometry
    from pointcept_tpu_torch.models.utils.structure import PointBatch, serialization_depth

    np.random.seed(0)
    random.seed(0)
    dataset = _quiet(lambda: build_dataset(cfg.data.train), os.path.join(cfg.save_path, "geometry.log"))
    pb = make_point_batch(point_collate_fn([dataset[0], dataset[1]], capacity), 2, device=device)
    grid_bits, orders = pb.grid_depth, backbone.order
    depth = serialization_depth(backbone.serialize_depth, pb)
    own = _pool_chain(capacity, own_factors)
    levels, mixed, cap = [], 0, pb.capacity
    with torch.no_grad():
        pb = pb.serialize(orders=orders, depth=depth)
        for s in range(len(backbone.enc_depths)):
            if s > 0:
                cap = backbone._pooled_capacity(cap, s)
                g = pooling_geometry(pb, backbone.stride[s - 1], cap, orders, tuple(range(len(orders))),
                                     identity_order0=s > 1)
                pb = PointBatch(coord=torch.zeros((cap, 3), device=device), feat=None, grid_coord=g["grid"],
                                batch=g["batch"], serialized_keys=g["keys"], serialized_order=g["order"],
                                serialized_inverse=g["inverse"], serialized_depth=g["depth"], num_scenes=2)
                clusters = int((g["batch"] >= 0).sum())
                levels.append(dict(clusters=clusters, capacity=cap, dropped=int(g["overflow"]),
                                   config_capacity=own[s - 1], config_drops=clusters > own[s - 1]))
            k = backbone.enc_patch_size[s]
            for oi in range(len(orders)):
                slot_to_point, _ = pb.patch_partition(oi, k)
                b = pb.batch[slot_to_point.long()].reshape(-1, k)
                mixed += int((b.amin(1) != b.amax(1)).sum())
    out = dict(rows=capacity, grid_bits=grid_bits, depth=depth, serialize_depth=backbone.serialize_depth,
               levels=levels, mixed_patches=mixed)
    if mixed or any(lv["dropped"] for lv in levels):
        raise AssertionError(f"outdoor geometry: {mixed} patches hold two scans, drops "
                             f"{[lv['dropped'] for lv in levels]}")
    return out


def _attention_per_step(launches: dict, steps: int, evals: dict, blocks: int, evaluations: int = 1) -> tuple:
    """Attention forwards and backwards a train step: every val forward of
    each of the `evaluations` attends once a block."""
    return ((launches["patch_attention"] - evaluations * len(evals["batch_ms"]) * blocks) / steps,
            launches["patch_attention_bwd"] / steps)


def _outdoor_run(device, card, work: str, config: str, options: dict, tag: str, own_factors, evaluations=1):
    """`_run_checked` of an outdoor PT-v3m1 config with both attention
    kernels launched, its step times, peak, attention launches a step and
    geometry (`outdoor_geometry`) emitted; returns (trainer, steps, evals,
    launches)."""
    trainer, steps, evals, launches, peak, seconds = _run_checked(
        device, work, config, options, tag, ("patch_attention", "patch_attention_bwd"))
    bb = trainer.cfg.model.backbone
    blocks = sum(bb.enc_depths) + sum(bb.dec_depths)
    fwd, bwd = _attention_per_step(launches, len(steps), evals, blocks, evaluations)
    geometry = outdoor_geometry(device, trainer.model.backbone, trainer.cfg, trainer.cfg.point_capacity,
                                own_factors)
    emit(tag, config=config, options=options, card=card, seconds=seconds,
         parameters=sum(p.numel() for p in trainer.model.parameters()), classes=trainer.cfg.data.num_classes,
         steps=len(steps), losses=[st["loss"] for st in steps], **_step_times(steps), peak_memory_bytes=peak,
         peak_gb=peak / 1e9, val_mIoU=evals["mIoU"], eval_ms_per_scene=evals["batch_ms"], launches=launches,
         attention_fwd_per_step=fwd, attention_bwd_per_step=bwd, geometry=geometry)
    if fwd != blocks or bwd != blocks:
        raise AssertionError(f"{tag}: {fwd} attention forwards and {bwd} backwards a step, {blocks} blocks")
    return trainer, steps, evals, launches


def _outdoor_test(device, card, work: str, phase: str, config: str, root: str, name: str, raw: int,
                  options: dict, kernels=("patch_attention",)):
    """`test_scene` of an outdoor config's test section on scan `name`."""
    st = test_scene(device, card, work, phase, config, name, raw, dict(options, num_worker=0, seed=0,
                                                                      **{"data.test.data_root": root}),
                    kernels=kernels)
    if st["groups"] is None:
        raise AssertionError(f"{phase}: the PT-v3m1 config did not take the grouped path")
    return st


def kitti_path(device, card, work: str) -> dict:
    """Phase 20: SemanticKITTI's PTv3 config through the training CLI's
    `main_worker` on HDL-64E scans (sequences 00-01 train, 08 val), its
    test section (4 rotation views, the grouped path) on the val scan, then
    the test split's submission (sequence 11, no labels): one `.label` a
    frame, uint32, raw ids in `learning_map_inv`'s image."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.datasets.semantic_kitti import SemanticKITTIDataset
    from pointcept_tpu_torch.utils.config import Config

    root = os.path.join(work, "kitti")
    sizes = write_kitti(root, KITTI_FRAMES)
    cap = OUTDOOR_CAPACITY["kitti"]
    options = dict(OUTDOOR_OPTIONS, point_capacity=cap, point_capacity_val=cap,
                   **{"model.backbone.pool_capacity_factors": OUTDOOR_POOL["kitti"],
                      "data.train.data_root": root, "data.val.data_root": root})
    emit("kitti_setup", config=KITTI_CONFIG, options=options, raw_points=sizes)
    own = Config.fromfile(os.path.join(ROOT, KITTI_CONFIG)).model.backbone.pool_capacity_factors
    trainer, steps, evals, launches = _outdoor_run(device, card, work, KITTI_CONFIG, options, "kitti",
                                                   own)
    result = dict(trainer=launches)
    del trainer
    release()
    test = dict(weight=os.path.join(work, "kitti", "model", "model_last.pth"), point_capacity_test=cap // 2,
                **{"model.backbone.pool_capacity_factors": OUTDOOR_POOL["kitti"]})
    _outdoor_test(device, card, work, "kitti_test", KITTI_CONFIG, root, "08_000000", sizes["08_000000"], test)
    test = dict(test, **{"data.test.split": "test", "data.test.submit": True})
    _outdoor_test(device, card, work, "kitti_submit", KITTI_CONFIG, root, "11_000000", sizes["11_000000"], test)
    label = os.path.join(work, "kitti_submit", "result", "submit", "sequences", "11", "predictions", "000000.label")
    ids = np.fromfile(label, dtype=np.uint32)
    allowed = set(SemanticKITTIDataset.get_learning_map_inv(-1).values()) - {-1}
    files = sorted(os.listdir(os.path.dirname(label)))
    emit("kitti_submission", files=files, points=int(ids.size), ids=sorted(int(v) for v in np.unique(ids)))
    if files != ["000000.label"] or ids.size != sizes["11_000000"] or not set(np.unique(ids).tolist()) <= allowed:
        raise AssertionError(f"kitti submission: {files}, {ids.size} ids for {sizes['11_000000']} points, "
                             f"ids {np.unique(ids)[:8]}")
    return result


_RESUMES = []  # the resume children started and not yet finished


def start_resume(work: str, config: str, options: dict, first: str, tag: str, keys=("loss",)) -> dict:
    """Start the second epoch again through the training CLI, resumed from
    `first`'s epoch_1.pth, in a child process; `finish_resume` holds its
    losses (`keys` of metrics.jsonl) against the straight run's, bit for
    bit. The child is mostly start-up on the host (two steps on the card)
    and runs beside the next phases, which share the card with it: those
    phases' times include its two steps, and their peaks plus its own stay
    under the card's memory (the callers pick such phases)."""
    import torch

    release()
    resumed = os.path.join(work, f"{tag}_resumed")
    argv = [sys.executable, os.path.join(ROOT, "tools", "torch_port_train.py"), "--config-file",
            os.path.join(ROOT, config), "--options"]
    # no evaluation after the resumed epoch: the check reads its losses alone
    argv += [f"{k}={v}" for k, v in dict(options, save_path=resumed, resume=True, evaluate=False,
                                          weight=os.path.join(first, "model", "epoch_1.pth")).items()]
    run = dict(proc=subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
               t0=time.perf_counter(), parent_reserved=torch.cuda.memory_reserved(), first=first,
               resumed=resumed, tag=tag, keys=keys)
    _RESUMES.append(run)
    return run


def finish_resume(run: dict) -> None:
    """Wait for a `start_resume` child and check its losses."""
    proc = run["proc"]
    _RESUMES.remove(run)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        print(out[-4000:], file=sys.stderr)
        print(err[-4000:], file=sys.stderr)
        raise AssertionError(f"the training CLI exited with {proc.returncode} "
                             f"(this process held {run['parent_reserved']} bytes of the card at its start)")
    want = [[r[k] for k in run["keys"]] for r in _metrics(run["first"]) if r["epoch"] == 2]
    got = [[r[k] for k in run["keys"]] for r in _metrics(run["resumed"])]
    emit(f"{run['tag']}_resume", seconds=time.perf_counter() - run["t0"], parent_reserved_bytes=run["parent_reserved"],
         losses=got, first_run=want, bit_identical=got == want)
    if got != want:
        raise AssertionError(f"{run['tag']}: resumed epoch 2 losses {got} differ from the first run's {want}")


def nuscenes_path(device, card, work: str) -> dict:
    """Phase 21: nuScenes' PTv3 config through the training CLI's
    `main_worker` on HDL-32E sweeps in the info layout (two epochs of 2
    steps, an evaluation and a checkpoint each), its test section on the
    val sweep, then the test split's lidarseg submission: one uint8
    ``<lidar token>_lidarseg.bin`` a sweep of the challenge's classes 1-16,
    and ``test/submission.json``."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.utils.config import Config

    root = os.path.join(work, "nuscenes")
    sizes = write_nuscenes(root, NUSCENES_SPLITS)
    names = sorted(sizes)
    cap = OUTDOOR_CAPACITY["nuscenes"]
    options = dict(OUTDOOR_OPTIONS, point_capacity=cap, point_capacity_val=cap, eval_epoch=2,
                   **{"hooks.4.save_freq": 1, "model.backbone.pool_capacity_factors": OUTDOOR_POOL["nuscenes"],
                      "data.train.data_root": root, "data.val.data_root": root})
    emit("nuscenes_setup", config=NUSCENES_CONFIG, options=options, raw_points=sizes)
    own = Config.fromfile(os.path.join(ROOT, NUSCENES_CONFIG)).model.backbone.pool_capacity_factors
    trainer, steps, evals, launches = _outdoor_run(device, card, work, NUSCENES_CONFIG, options,
                                                   "nuscenes", own, evaluations=2)
    result = dict(trainer=launches)
    del trainer
    release()
    # (its resumed epoch, bit-identical in PRs 12-15, is left to phases 10, 13 and 29 for the time limit)
    test = dict(weight=os.path.join(work, "nuscenes", "model", "model_last.pth"), point_capacity_test=cap,
                **{"model.backbone.pool_capacity_factors": OUTDOOR_POOL["nuscenes"]})
    val_name = [n for n in names if n.endswith(str(1533151603547590 + NUSCENES_SPLITS["val"][0]))][0]
    test_name = [n for n in names if n.endswith(str(1533151603547590 + NUSCENES_SPLITS["test"][0]))][0]
    _outdoor_test(device, card, work, "nuscenes_test", NUSCENES_CONFIG, root, val_name, sizes[val_name], test)
    test = dict(test, **{"data.test.split": "test", "data.test.submit": True})
    _outdoor_test(device, card, work, "nuscenes_submit", NUSCENES_CONFIG, root, test_name, sizes[test_name], test)
    submit = os.path.join(work, "nuscenes_submit", "result", "submit")
    token = f"{NUSCENES_SPLITS['test'][0]:032x}"
    files = sorted(os.listdir(os.path.join(submit, "lidarseg", "test")))
    preds = np.fromfile(os.path.join(submit, "lidarseg", "test", f"{token}_lidarseg.bin"), dtype=np.uint8)
    with open(os.path.join(submit, "test", "submission.json")) as f:
        meta = json.load(f)["meta"]
    emit("nuscenes_submission", files=files, points=int(preds.size), classes=sorted(int(v) for v in np.unique(preds)),
         meta=meta)
    if (files != [f"{token}_lidarseg.bin"] or preds.size != sizes[test_name] or preds.min() < 1 or preds.max() > 16
            or not meta["use_lidar"]):
        raise AssertionError(f"nuscenes submission: {files}, {preds.size} preds for {sizes[test_name]} points, "
                             f"classes {np.unique(preds)}")
    return result


def waymo_path(device, card, work: str) -> dict:
    """Phase 22: Waymo's PTv3 config through the training CLI's
    `main_worker` on two-return top-lidar frames at the config's 262,144
    rows a frame: 4 steps of two frames (524,288 rows), one evaluation."""
    import torch

    from pointcept_tpu_torch.utils.config import Config

    root = os.path.join(work, "waymo")
    sizes = write_waymo(root, WAYMO_SPLITS)
    cap = OUTDOOR_CAPACITY["waymo"]
    options = dict(OUTDOOR_OPTIONS, point_capacity=cap, **{"data.train.data_root": root,
                                                           "data.val.data_root": root})
    emit("waymo_setup", config=WAYMO_CONFIG, options=options, raw_points=sizes)
    own = Config.fromfile(os.path.join(ROOT, WAYMO_CONFIG)).model.backbone.pool_capacity_factors
    trainer, steps, evals, launches = _outdoor_run(device, card, work, WAYMO_CONFIG, options, "waymo", own)
    if trainer.cfg.point_capacity != 2 * trainer.cfg.point_capacity_val:
        raise AssertionError(f"waymo: {trainer.cfg.point_capacity} rows a step")
    del trainer
    release()
    return dict(trainer=launches)


def outdoor_probe_path(device, card, work: str) -> dict:
    """Phase 23: Utonia's nuScenes fine-tune (PT-v3m3, head dim 18, both
    attention kernels, every tensor trained) and Concerto-large's
    SemanticKITTI linear probe (the encoder frozen: its tensors the
    checkpoint's bit for bit after the steps, no attention backward), each
    from a random encoder saved under ``student.backbone.`` and at
    ``in_channels=4``, on phases 20-21's scans at serialize_depth 11, with
    the geometry of two scans (no patch holding both). Returns the launches
    of each."""
    import torch

    from pointcept_tpu_torch.models import build_model
    from pointcept_tpu_torch.utils.config import Config

    result = {}
    for seed, (tag, config, sensor) in enumerate(OUTDOOR_PROBES, start=21):
        cfg = Config.fromfile(os.path.join(ROOT, config))
        cfg.merge_from_dict(OUTDOOR_PROBE_OPTIONS)
        weight = os.path.join(work, f"{tag}_encoder.pth")
        pretrained = build_model(dict(cfg.model.backbone), device="cpu", generator=torch.Generator().manual_seed(seed))
        ckpt = {"backbone." + k: v for k, v in pretrained.state_dict().items()}
        torch.save({"state_dict": {"student." + k: v for k, v in ckpt.items()}}, weight)
        del pretrained
        root, cap = os.path.join(work, sensor), OUTDOOR_CAPACITY[sensor]
        options = dict(OUTDOOR_OPTIONS, weight=weight, point_capacity=cap, point_capacity_val=cap,
                       **OUTDOOR_PROBE_OPTIONS, **{"data.train.data_root": root, "data.val.data_root": root})
        trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, config, options, tag,
                                                                      ("patch_attention",))
        model, bb = trainer.model, trainer.cfg.model.backbone
        info = trainer.comm_info.get("load_info", {})
        blocks = sum(bb.enc_depths)
        fwd, bwd = _attention_per_step(launches, len(steps), evals, blocks)
        same, moved = _moved(model, ckpt, "backbone.")
        d = sorted({c // h for c, h in zip(bb.enc_channels, bb.enc_num_head)})
        geometry = outdoor_geometry(device, model.backbone, trainer.cfg, cap, bb.get("pool_capacity_factors",
                                                                                     (0.5,) * 4))
        emit(tag, config=config, options=dict(options, weight=f"random encoder, seed {seed}"), card=card,
             seconds=seconds, head_dims=d, steps=len(steps), losses=[st["loss"] for st in steps],
             **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9, val_mIoU=evals["mIoU"],
             eval_ms_per_scene=evals["batch_ms"], launches=launches, attention_fwd_per_step=fwd,
             attention_bwd_per_step=bwd, missing_keys=info.get("missing", []), encoder_unchanged=len(same),
             encoder_moved=len(moved), parameters=sum(p.numel() for p in model.parameters()), geometry=geometry)
        if set(info.get("missing", [])) != {"seg_head.weight", "seg_head.bias"}:
            raise AssertionError(f"{tag}: missing keys {info.get('missing')}")
        frozen = bool(trainer.cfg.model.get("freeze_backbone", False))
        want_bwd = 0 if frozen else blocks
        if fwd != blocks or bwd != want_bwd:
            raise AssertionError(f"{tag}: {fwd} attention forwards and {bwd} backwards a step, {blocks} blocks")
        if frozen and (moved or not same):
            raise AssertionError(f"{tag}: frozen encoder tensors moved, e.g. {moved[:3]}")
        # (the mask token: no patch mask in a fine-tune, no gradient)
        if not frozen and [n for n in same if n != "backbone.embedding.mask_token"]:
            raise AssertionError(f"{tag}: {len(same)} encoder tensors not updated, e.g. {same[:3]}")
        result[tag] = launches
        del trainer, model
        release()
    return result


def write_structured3d_rooms(root: str, seeds, points: int = RAW_POINTS) -> list:
    """Synthetic rooms in Structured3D's preprocessed layout, one directory
    of .npy files a room under ``root/train/scene_<seed>_room_0`` (`coord`,
    `color` as uint8, `normal`, `segment` of its 25 classes, `instance`);
    returns their points."""
    from pointcept_tpu_torch.datasets import synthesize_scene

    import numpy as np

    sizes = []
    for seed in seeds:
        d = os.path.join(root, "train", f"scene_{seed:05d}_room_0")
        os.makedirs(d)
        sc = synthesize_scene(seed, num_points=points, num_classes=S3D_CLASSES, extent=6.0)
        np.save(os.path.join(d, "coord.npy"), sc["coord"])
        np.save(os.path.join(d, "color.npy"), sc["color"].astype(np.uint8))
        np.save(os.path.join(d, "normal.npy"), sc["normal"])
        np.save(os.path.join(d, "segment.npy"), sc["segment"].astype(np.int16))
        np.save(os.path.join(d, "instance.npy"), sc["instance"].astype(np.int16))
        sizes.append(len(sc["coord"]))
    return sizes


def _pd_norms(model):
    """Every PDNorm of `model` with batch norms: (name, module)."""
    from pointcept_tpu_torch.models.modules import PDNorm

    return [(n, m) for n, m in model.named_modules() if isinstance(m, PDNorm) and m.norm_type == "bn" and m.decouple]


def ppt_step_checks(trainer, device, batches) -> list:
    """Bare train steps of the trainer's model and optimizer on `batches`
    (one a condition): the running statistics of the batch's condition's
    norms move and every other condition's stay bit for bit; the context
    table's gradient is the batch's condition's row alone (none where no
    norm is adaptive: the context is then read by nothing); an adaptive
    PDNorm's modulation has a gradient. Rows: one a step. (The weights of
    the other conditions' rows still move by SGD's momentum and weight
    decay, which reach every row of a table: the check reads gradients.)"""
    import torch

    from pointcept_tpu_torch.engines import build_train_step, make_point_batch

    model = trainer.model
    step = build_train_step(model, trainer.optimizer, trainer.build_scheduler(), trainer.cfg.get("clip_grad"))
    generator = torch.Generator(device=device)
    norms = _pd_norms(model)
    rows = []
    for i, batch in enumerate(batches):
        cond = batch["condition"]
        before = {n: [(bn.running_mean.clone(), bn.running_var.clone()) for bn in getattr(m, m.decoupled_name)]
                  for n, m in norms}
        generator.manual_seed(i)
        res = step(make_point_batch(batch, batch["num_scenes"], device=device), generator)
        moved, kept, touched_other = 0, 0, []
        for n, m in norms:
            for j, (bn, (mean, var)) in enumerate(zip(getattr(m, m.decoupled_name), before[n])):
                same = torch.equal(bn.running_mean, mean) and torch.equal(bn.running_var, var)
                if j == m.conditions.index(cond):
                    moved += int(not same)
                else:
                    kept += int(same)
                    if not same:
                        touched_other.append(f"{n}[{m.conditions[j]}]")
        table = model.embedding_table.weight.grad
        row = model.conditions.index(cond)
        # (a model without adaptive norms reads no context: its table has no gradient)
        nonzero_rows = [] if table is None else [i for i in range(table.shape[0]) if bool(table[i].abs().sum() > 0)]
        modulation = [p.grad for n, p in model.named_parameters() if ".modulation." in n]
        rows.append(dict(condition=cond, loss=float(res["loss"]), norms=len(norms), own_norms_moved=moved,
                         other_norms_kept=kept, other_norms_touched=touched_other[:3], context_grad_rows=nonzero_rows,
                         context_row=row, modulation_tensors=len(modulation),
                         modulation_with_grad=sum(int(g is not None and bool(g.abs().sum() > 0)) for g in modulation)))
    return rows


def ppt_path(device, card, work: str, config: str, tag: str, s3d_rooms: int, test: bool) -> dict:
    """Phases 24-25: a PPT config through the training CLI's `main_worker`
    and `MultiDatasetTrainer` on synthetic Structured3D rooms (the first
    `s3d_rooms` of PPT_S3D_SEEDS) and phase 10's ScanNet train scenes, one
    evaluation on ScanNet val scene 5; then its loader's batches read again
    for the ratio pattern and the length, and bare steps of one Structured3D
    and one ScanNet batch (`ppt_step_checks`); with `test`, the config's
    test section on a 102,400-point ScanNet val scene (the grouped path)
    with the condition of every forward recorded. Returns the launches."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.models.point_prompt_training import PointPromptTraining

    scannet = os.path.join(work, "scannet")
    s3d = os.path.join(work, "structured3d")
    if not os.path.isdir(s3d):
        write_structured3d_rooms(s3d, PPT_S3D_SEEDS)
    s3d_root = os.path.join(work, f"structured3d_{s3d_rooms}")
    os.makedirs(os.path.join(s3d_root, "train"))
    for name in sorted(os.listdir(os.path.join(s3d, "train")))[:s3d_rooms]:
        os.symlink(os.path.join(s3d, "train", name), os.path.join(s3d_root, "train", name))
    val_root = os.path.join(work, "scannet_val1")
    if not os.path.isdir(val_root):
        os.makedirs(os.path.join(val_root, "val"))
        os.symlink(os.path.join(scannet, "val", "scene0005_00"), os.path.join(val_root, "val", "scene0005_00"))
    options = dict(PPT_OPTIONS, **PPT_POOL_OPTIONS[config],
                   **{"data.train.datasets.0.data_root": s3d_root, "data.train.datasets.1.data_root": scannet,
                      "data.val.data_root": val_root})
    trainer, steps, evals, launches, peak, seconds = _run_config(device, work, config, options, tag)
    bb = trainer.cfg.model.backbone
    geometry = None
    if bb.type.startswith("PT-v3"):
        # two Structured3D rooms of the train pipeline: each level's clusters at
        # the run's capacities and the config's own
        geometry = outdoor_geometry(device, trainer.model.backbone, trainer.cfg, trainer.cfg.point_capacity,
                                    PPT_POOL)
    loader = trainer.train_loader
    loader.set_epoch(0)
    conditions, firsts = [], {}
    for batch in loader:
        conditions.append(batch["condition"])
        firsts.setdefault(batch["condition"], batch)
    pattern = [PPT_PATTERN[i % len(PPT_PATTERN)] for i in range(len(conditions))]
    checks = ppt_step_checks(trainer, device, [firsts["Structured3D"], firsts["ScanNet"]])
    row = dict(config=config, options=options, card=card, seconds=seconds,
               parameters=sum(p.numel() for p in trainer.model.parameters()), steps=len(steps),
               loader_len=len(loader), conditions=conditions, losses=[st["loss"] for st in steps],
               **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9, val_mIoU=evals["mIoU"],
               eval_ms_per_scene=evals["batch_ms"], launches=launches, step_checks=checks, geometry=geometry)
    if bb.type.startswith("PT-v3"):
        blocks = sum(bb.enc_depths) + sum(bb.dec_depths)
        row["attention_fwd_per_step"], row["attention_bwd_per_step"] = _attention_per_step(
            launches, len(steps), evals, blocks)
    emit(tag, **row)
    if len(steps) != PPT_STEPS[config] or len(loader) != len(steps) or conditions != pattern:
        raise AssertionError(f"{tag}: {len(steps)} steps, loader length {len(loader)}, conditions {conditions}")
    for ck in checks:
        rows = [ck["context_row"]] if ck["modulation_tensors"] else []
        if (ck["other_norms_touched"] or ck["own_norms_moved"] == 0 or ck["context_grad_rows"] != rows
                or ck["modulation_with_grad"] != ck["modulation_tensors"]):
            raise AssertionError(f"{tag}: the step of condition {ck['condition']} reached beyond it: {ck}")
    if bb.type.startswith("PT-v3"):
        if row["attention_fwd_per_step"] != blocks or row["attention_bwd_per_step"] != blocks:
            raise AssertionError(f"{tag}: {row['attention_fwd_per_step']} attention forwards and "
                                 f"{row['attention_bwd_per_step']} backwards a step, {blocks} blocks")
        for name in TRAIN_KERNELS:
            if launches[name] == 0:
                raise AssertionError(f"kernel {name} was not launched by {tag}")
    weight = os.path.join(work, tag, "model", "model_last.pth")
    del trainer, loader, firsts
    release()
    if test:
        test_root = os.path.join(work, "ppt_test")
        raw = write_scannet_scene(test_root, "val", int(TESTER_SCENE[5:9]), TESTER_POINTS)
        seen = []
        forward = PointPromptTraining.forward

        def recording(self, pb, *args, **kwargs):
            seen.append(pb.condition)
            return forward(self, pb, *args, **kwargs)

        PointPromptTraining.forward = recording
        try:
            st = test_scene(device, card, work, f"{tag}_test", config, TESTER_SCENE, raw,
                            dict(TESTER_OPTIONS, weight=weight, num_worker=0,
                                 **{"data.test.data_root": test_root}))
        finally:
            PointPromptTraining.forward = forward
        emit(f"{tag}_test_conditions", forwards=len(seen), conditions=sorted(set(seen)))
        if st["groups"] is None or not seen or set(seen) != {"ScanNet"}:
            raise AssertionError(f"{tag} tester: groups {st['groups']}, forwards' conditions {sorted(set(seen))}")
    return launches


def ppt_card_vs_cpu(device):
    """Phase 24's card against the CPU: one train step of PPT-extreme at one
    block a stage (PPT-v1m1, decoupled PDNorm on every norm), f32, at the
    ScanNet condition, within phase 8's bounds, on a scene of 8,192 points
    (1.7 m, phase 8's density; at phase 8's 16,384 its three steps took 54 s
    of the time limit)."""
    card_vs_cpu_train(device, **ppt_cvct())


def ppt_cvct() -> dict:
    """Phase 24's `card_vs_cpu_train` arguments."""
    from pointcept_tpu_torch.utils.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, PPT_CONFIG))
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4, drop_path=0.0, amp=False,
                    block_engine_min_points=4096, block_capacity_factor=(1 / 8,) * 5, pool_capacity_factors=(0.5,) * 4)
    model = dict(cfg.model, backbone=backbone)
    recipe = dict(optimizer=dict(cfg.optimizer), param_dicts=list(cfg.param_dicts), scheduler=dict(cfg.scheduler))
    return dict(cases=[(False, model, recipe)], phase="ppt_card_vs_cpu_train", capacity=8192, extent=1.7,
                condition="ScanNet")


def _val_scene5(work: str) -> str:
    """A data root whose val split is phase 10's val scene 5 alone."""
    val_root = os.path.join(work, "scannet_val1")
    if not os.path.isdir(val_root):
        os.makedirs(os.path.join(val_root, "val"))
        os.symlink(os.path.join(work, "scannet", "val", "scene0005_00"), os.path.join(val_root, "val", "scene0005_00"))
    return val_root


def insseg_ptv3_path(device, card, work: str) -> dict:
    """Phase 26: the PTv3 PointGroup config through the training CLI's
    `main_worker` on phase 10's scenes (4 steps, InsSegEvaluator on both val
    scenes): a later step's ms, data time and peak, the three loss terms, the
    attention launches a step, AP and proposals a scene, the host
    clustering's ms; limits: nothing dropped at any pooling level, finite
    losses, every tensor moved. Then its InsSegTester on val scene 5 and one
    small-depth train step on the card against the CPU (f32). Returns the
    launches of the train run."""
    import torch

    from pointcept_tpu_torch.models import apply_amp_policy, build_model

    data_root = os.path.join(work, "scannet")
    options = dict(DOWNSTREAM_OPTIONS, **INSSEG_POOL_OPTIONS,
                   **{"data.train.data_root": data_root, "data.val.data_root": data_root})
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, INSSEG_CONFIG, options, "insseg",
                                                                  TRAIN_KERNELS[:2])
    cfg = trainer.cfg
    initial = build_model(apply_amp_policy(dict(cfg.model), cfg.enable_amp), device=device,
                          generator=torch.Generator().manual_seed(cfg.shared_seed))
    unchanged = [n for (n, a), b in zip(initial.named_parameters(), trainer.model.parameters())
                 if torch.equal(a, b.detach())]
    del initial
    rows = _metrics(os.path.join(work, "insseg"))
    bb = cfg.model.backbone
    blocks = sum(bb.enc_depths) + sum(bb.dec_depths)
    fwd, bwd = _attention_per_step(launches, len(steps), evals, blocks)
    row = dict(config=INSSEG_CONFIG, options=options, card=card, seconds=seconds,
               parameters=sum(p.numel() for p in trainer.model.parameters()), steps=len(steps),
               **{k: [r[k] for r in rows] for k in ("loss", "seg_loss", "bias_l1_loss", "bias_cosine_loss")},
               collate_dropped=[r.get("collate_dropped") for r in rows], **_step_times(steps),
               peak_memory_bytes=peak, peak_gb=peak / 1e9, mAP=evals["mAP"], AP50=evals["AP50"], AP25=evals["AP25"],
               val_loss=evals["loss"], proposals_per_scene=evals["proposals"], gt_instances=evals["gt_instances"],
               eval_ms_per_scene=evals["batch_ms"], eval_forward_ms=evals["forward_ms"],
               cluster_ms_per_scene=evals["cluster_ms"], launches=launches, attention_fwd_per_step=fwd,
               attention_bwd_per_step=bwd, unchanged_parameters=len(unchanged))
    emit("insseg_ptv3", **row)
    if fwd != blocks or bwd != blocks:
        raise AssertionError(f"insseg: {fwd} attention forwards and {bwd} backwards a step, {blocks} blocks")
    if unchanged:
        raise AssertionError(f"insseg: {len(unchanged)} parameters not updated, e.g. {unchanged[:3]}")
    if not all(math.isfinite(v) for k in ("seg_loss", "bias_l1_loss", "bias_cosine_loss") for v in row[k]):
        raise AssertionError("insseg: a non-finite loss term")
    del trainer
    release()
    insseg_tester(device, card, work, INSSEG_CONFIG, os.path.join(work, "insseg", "model", "model_last.pth"),
                  "insseg_test")

    card_vs_cpu_train(device, **insseg_cvct())
    return launches


def insseg_cvct() -> dict:
    """Phase 26's `card_vs_cpu_train` arguments: one small-depth PointGroup
    step (f32)."""
    from pointcept_tpu_torch.utils.config import Config

    base = Config.fromfile(os.path.join(ROOT, INSSEG_CONFIG))
    backbone = dict(base.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4, drop_path=0.0, amp=False,
                    pool_capacity_factors=(0.5,) * 4)
    recipe = dict(optimizer=dict(base.optimizer), param_dicts=list(base.param_dicts), scheduler=dict(base.scheduler))
    # at 4,096 points (1.2 m, as SpUNet's): the time limit's room for phases 29-31
    return dict(cases=[(False, dict(base.model, backbone=backbone), recipe)], phase="insseg_card_vs_cpu_train",
                capacity=4096, extent=1.2, instances=True)


def insseg_tester(device, card, work: str, config: str, weight: str, phase: str, data_root=None) -> dict:
    """A PointGroup config's InsSegTester through the test CLI's
    `main_worker` (its ``test=dict()``: the val data) on val scene 5, or on
    `data_root`'s val split: scene ms, forward ms, host clustering ms and
    proposals; nothing dropped, attention launched."""
    import torch

    from pointcept_tpu_torch.engines import default_config_parser
    from pointcept_tpu_torch.ops.kernels import KERNELS

    save = os.path.join(work, phase)
    options = dict(weight=weight, seed=0, num_worker=0, point_capacity_test=262144,
                   **{"data.val.data_root": data_root or _val_scene5(work)})
    cfg = default_config_parser(os.path.join(ROOT, config), dict(options, save_path=save))
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    tester, result = _quiet(lambda: _test_main_worker()(cfg), os.path.join(work, "tester.log"))
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    stats = list(tester.scene_stats)
    emit(phase, config=config, card=card, seconds=seconds, scenes=stats, mAP=result["mAP"], AP50=result["AP50"],
         AP25=result["AP25"], launches=launches)
    if not stats or any(st["dropped"] for st in stats) or launches["patch_attention"] == 0:
        raise AssertionError(f"{phase}: scenes {stats}, attention launches {launches['patch_attention']}")
    del tester
    release()
    return result


def insseg_overfit_path(device, card, work: str) -> dict:
    """Phase 27: the SpUNet PointGroup config's own model, optimizer,
    schedule and transforms on one synthetic scene (train and val its one
    scene) for INSSEG_OVERFIT_OPTIONS' steps, then InsSegEvaluator on
    it: the limit is AP50 > INSSEG_OVERFIT_AP50 on the scene it trained on
    (the offsets, the clustering and the matching working together)."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.datasets import synthesize_scene

    root = os.path.join(work, "insseg_overfit")
    sc = synthesize_scene(INSSEG_OVERFIT_SCENE["seed"], num_points=INSSEG_OVERFIT_SCENE["points"],
                          num_classes=NUM_CLASSES, extent=INSSEG_OVERFIT_SCENE["extent"])
    d = os.path.join(root, "train", "scene0031_00")
    os.makedirs(d)
    for key, value in (("coord", sc["coord"]), ("color", sc["color"].astype(np.uint8)), ("normal", sc["normal"]),
                       ("segment20", sc["segment"].astype(np.int16)), ("instance", sc["instance"].astype(np.int16))):
        np.save(os.path.join(d, f"{key}.npy"), value)
    os.makedirs(os.path.join(root, "val"))
    os.symlink(d, os.path.join(root, "val", "scene0031_00"))
    options = dict(INSSEG_OVERFIT_OPTIONS, **{"data.train.data_root": root, "data.val.data_root": root})
    trainer, steps, evals, launches, peak, seconds = _run_config(device, work, INSSEG_OVERFIT_CONFIG, options,
                                                                 "insseg_overfit")
    rows = _metrics(os.path.join(work, "insseg_overfit"))
    batch_stats = _quiet(lambda: batch_stats_ap(trainer), os.path.join(work, "trainer.log"))
    row = dict(config=INSSEG_OVERFIT_CONFIG, options=options, card=card, seconds=seconds, steps=len(steps),
               raw_points=len(sc["coord"]), instances=int(len(np.unique(sc["instance"][sc["instance"] >= 0]))),
               loss_at_step={i: rows[i - 1]["loss"] for i in (1, 50, 100, 150) if i <= len(rows)},
               terms_at_end={k: rows[-1][k] for k in ("seg_loss", "bias_l1_loss", "bias_cosine_loss")},
               median_batch_time_ms=statistics.median(st["batch_time_ms"] for st in steps), peak_gb=peak / 1e9,
               mAP=evals["mAP"], AP50=evals["AP50"], AP25=evals["AP25"], per_overlap=evals["per_overlap"],
               proposals=evals["proposals"], gt_instances=evals["gt_instances"], cluster_ms=evals["cluster_ms"],
               val_loss=evals["loss"], limit_AP50=INSSEG_OVERFIT_AP50, limit_met=evals["AP50"] > INSSEG_OVERFIT_AP50,
               batch_stats=batch_stats)
    emit("insseg_overfit", **row)
    del trainer
    release()
    if len(steps) != INSSEG_OVERFIT_OPTIONS["epoch"]:
        raise AssertionError(f"insseg overfit: {len(steps)} steps")
    if not row["limit_met"]:
        # a convergence figure, reported with its numbers (PERF.md): the run itself held every other limit
        emit("insseg_overfit_limit_missed", AP50=evals["AP50"], limit=INSSEG_OVERFIT_AP50, proposals=evals["proposals"],
             gt_instances=evals["gt_instances"], batch_stats_AP50=batch_stats["AP50"])
    return row


def batch_stats_ap(trainer) -> dict:
    """The evaluator's AP again, on a copy of the model whose norms take
    each val batch's own statistics (train mode, no gradient): what the
    offsets, the clustering and the matching give apart from the running
    statistics, which after 75 steps at the config's momentum 0.01 still
    hold 0.99^75 = 47% of their initial values."""
    import copy
    from types import SimpleNamespace

    import torch

    from pointcept_tpu_torch.engines.hooks import InsSegEvaluator

    model = copy.deepcopy(trainer.model).train()
    model.eval = lambda: model  # the hook's eval() keeps the batch statistics
    (hook_cfg,) = [dict(h) for h in trainer.cfg.hooks if h["type"] == "InsSegEvaluator"]
    hook = InsSegEvaluator(**{k: v for k, v in hook_cfg.items() if k != "type"})
    hook.trainer = SimpleNamespace(model=model, cfg=trainer.cfg, val_loader=trainer.val_loader, device=trainer.device,
                                   logger=trainer.logger, storage=None, comm_info={})
    with torch.no_grad():
        res = hook.eval()
    del model
    return {k: res[k] for k in ("mAP", "AP50", "AP25", "proposals", "loss")}


def insseg_probe_path(device, card, work: str) -> dict:
    """Phase 28: Sonata's PointGroup linear probe on phase 13's checkpoint
    (its student backbone, by the config's CheckpointLoader) at phase 14's
    cuts: the missing and unexpected keys logged; limits: every backbone
    tensor as loaded bit for bit (the encoder the checkpoint's, the decoder
    its seeded init: the checkpoint holds an encoder alone), no attention
    backward, the bias and seg heads alone trainable and moved. Returns the
    launches."""
    import torch

    from pointcept_tpu_torch.models import apply_amp_policy, build_model

    data_root = os.path.join(work, "scannet")
    weight = os.path.join(work, "sonata", "model", "model_last.pth")
    ckpt = torch.load(weight, map_location="cpu", weights_only=False)["state_dict"]
    student = {"backbone." + k[len("student.backbone."):]: v for k, v in ckpt.items()
               if k.startswith("student.backbone.")}
    del ckpt
    options = dict(DOWNSTREAM_OPTIONS, weight=weight, **{"data.train.data_root": data_root,
                                                        "data.val.data_root": _val_scene5(work)})
    trainer, steps, evals, launches, peak, seconds = _run_config(device, work, INSSEG_PROBE_CONFIG, options,
                                                                 "insseg_probe")
    model, cfg = trainer.model, trainer.cfg
    info = trainer.comm_info.get("load_info", {})
    missing, unexpected = info.get("missing", []), info.get("unexpected", [])
    initial = build_model(apply_amp_policy(dict(cfg.model), cfg.enable_amp), device="cpu",
                          generator=torch.Generator().manual_seed(cfg.shared_seed))
    # as loaded: the encoder's tensors the checkpoint's, the rest their seeded init
    loaded = {n: student.get(n, p.detach()) for n, p in initial.named_parameters()}
    del initial
    same, moved = _moved(model, loaded, "backbone.")
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    heads = [n for n, _ in model.named_parameters() if n.startswith(("bias_head.", "seg_head."))]
    head_same = [n for n in _moved(model, loaded)[0] if n in heads]
    row = dict(config=INSSEG_PROBE_CONFIG, card=card, seconds=seconds, steps=len(steps),
               losses=[st["loss"] for st in steps], **_step_times(steps), peak_gb=peak / 1e9, mAP=evals["mAP"],
               AP50=evals["AP50"], proposals_per_scene=evals["proposals"], cluster_ms_per_scene=evals["cluster_ms"],
               launches=launches, missing_keys=missing, unexpected_keys=len(unexpected),
               unexpected_prefixes=sorted({k.split(".")[0] + "." + k.split(".")[1] for k in unexpected}),
               encoder_loaded=sum(n in student for n in loaded),
               backbone_tensors=sum(n.startswith("backbone.") for n in loaded), backbone_unchanged=len(same),
               backbone_moved=moved[:5], trainable=trainable, heads_unmoved=head_same,
               parameters=sum(p.numel() for p in model.parameters()))
    emit("insseg_sonata_probe", **row)
    fresh = ("bias_head.", "seg_head.", "backbone.dec.")
    if not missing or not all(k.startswith(fresh) for k in missing) or not any(
            k.startswith("backbone.enc.") for k in loaded if k in student):
        raise AssertionError(f"insseg probe: loaded keys off: missing {missing[:5]}")
    if moved or len(same) != row["backbone_tensors"]:
        raise AssertionError(f"insseg probe: backbone tensors moved {moved[:3]}")
    if set(trainable) != set(heads) or head_same:
        raise AssertionError(f"insseg probe: trainable {trainable[:6]}, heads not moved {head_same[:3]}")
    if launches["patch_attention_bwd"] or launches["patch_attention"] == 0:
        raise AssertionError(f"insseg probe: attention launches {launches}")
    del trainer, model
    release()
    return launches


def _test_config(device, work: str, config: str, options: dict, tag: str) -> tuple:
    """A config's tester through the test CLI's `main_worker`, launch
    counters set to 0 just before and read just after: (tester, result,
    launches, seconds)."""
    import torch

    from pointcept_tpu_torch.engines import default_config_parser
    from pointcept_tpu_torch.ops.kernels import KERNELS

    cfg = default_config_parser(os.path.join(ROOT, config), dict(options, save_path=os.path.join(work, tag)))
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    tester, result = _quiet(lambda: _test_main_worker()(cfg), os.path.join(work, "tester.log"))
    torch.cuda.synchronize()
    return tester, result, {name: fn.launches for name, fn in KERNELS.items()}, time.perf_counter() - t0


def _cloud_stats(stats: list) -> dict:
    return {f"median_{k}": statistics.median(st[k] for st in stats) for k in ("cloud_ms", "forward_ms", "host_ms")}


def _stage_geometry(model, arrays: dict, device) -> list:
    """Each stage of an ``enc_mode`` PT-v3 backbone's eval forward on one
    collated batch: its rows, valid rows, the largest cloud's points and
    its patch and slots; and the points dropped."""
    import torch

    from pointcept_tpu_torch.engines import make_point_batch

    pb = make_point_batch(arrays, arrays["num_scenes"], device=device)
    was_training = model.training
    model.eval()
    with torch.no_grad():
        out, diag, skips = model.backbone(pb)
    model.train(was_training)
    rows = []
    patches = model.backbone.enc_patch_size if hasattr(model.backbone, "enc_patch_size") else None
    for stage, st in enumerate([sk[0] for sk in skips] + [out]):
        k = patches[stage]
        rows.append(dict(stage=stage, rows=st.capacity, valid=int(st.mask.sum()),
                         largest_cloud=int(st.scene_counts().max()), patch=k, slots=st.padded_capacity(k)))
    dropped = sum(int(v) for vs in diag.values() for v in vs)
    return rows, dropped


def cls_modelnet_path(device, card, work: str) -> dict:
    """Phase 29: ModelNet40's PTv3 classifier (`DefaultClassifier` over
    PT-v3m1 enc_mode at 32-512, the config's batch of 32 clouds) through the
    training CLI's `main_worker` on synthetic clouds in the
    `modelnet40_normal_resampled` layout: two 4-step epochs, an evaluation
    and a checkpoint each; a later step's ms, data time and peak, the
    attention launches a step, each stage's rows against its patch,
    ClsEvaluator's allAcc; limits: finite losses, nothing dropped, every
    tensor moved. Then the second epoch again through the CLI (the same
    loss bits: the fixed-order VJP of `TakeRows`, every cloud smaller than
    its patch), ClsTester on the 40 test clouds, the voting config's
    ClsVotingTester (100 repeats) on CLS_VOTE_CLOUDS, and one small-depth
    step on the card against the CPU (f32). Returns the train run's
    launches."""
    import torch

    from pointcept_tpu_torch.datasets import build_dataset, point_collate_fn
    from pointcept_tpu_torch.models import apply_amp_policy, build_model
    from pointcept_tpu_torch.utils.config import Config

    base = Config.fromfile(os.path.join(ROOT, CLS_CONFIG))
    root = os.path.join(work, "modelnet40")
    t0 = time.perf_counter()
    splits = write_modelnet(root, list(base.data.names))
    with open(os.path.join(root, "modelnet40_vote.txt"), "w") as f:
        f.write("".join(f"{n}\n" for n in splits["test"][:CLS_VOTE_CLOUDS]))
    written = time.perf_counter() - t0
    options = dict(CLS_OPTIONS, **{f"data.{s}.data_root": root for s in ("train", "val", "test")})
    emit("cls_setup", config=CLS_CONFIG, options=options, clouds={k: len(v) for k, v in splits.items()},
         file_points=CLS_FILE_POINTS, write_seconds=written)
    # one small-depth step (one block a stage, f32) on 4 clouds, card against
    # CPU: its CPU side queued now that the clouds exist
    run_cfg = Config.fromfile(os.path.join(ROOT, CLS_CONFIG))
    run_cfg.merge_from_dict(options)
    small = dict(base.model, backbone=dict(base.model.backbone, enc_depths=(1,) * 5, drop_path=0.0,
                                           pool_capacity_factors=CLS_OPTIONS["model.backbone.pool_capacity_factors"]))
    recipe = dict(optimizer=dict(base.optimizer), param_dicts=None,
                  scheduler=dict(base.scheduler, base_lr=base.optimizer.lr))
    train_ds = build_dataset(dict(run_cfg.data.train))
    cvct = dict(cases=[(False, small, recipe)], phase="cls_card_vs_cpu_train",
                batch=point_collate_fn([train_ds[i] for i in range(4)], capacity=4096))
    cpu_prefetch(card_vs_cpu_train_jobs(**cvct))
    trainer, steps, evals, launches, peak, seconds = _run_config(device, work, CLS_CONFIG, options, "cls_modelnet")
    cfg, model = trainer.cfg, trainer.model
    initial = build_model(apply_amp_policy(dict(cfg.model), cfg.enable_amp), device="cpu",
                          generator=torch.Generator().manual_seed(cfg.shared_seed))
    same, moved = _moved(model, {n: p.detach() for n, p in initial.named_parameters()})
    del initial
    blocks = sum(cfg.model.backbone.enc_depths)
    fwd, bwd = _attention_per_step(launches, len(steps), evals, blocks, evaluations=2)
    ds = build_dataset(dict(cfg.data.train))
    batch = point_collate_fn([ds[i] for i in range(cfg.batch_size)], capacity=cfg.point_capacity)
    geometry, dropped = _stage_geometry(model, batch, device)
    row = dict(config=CLS_CONFIG, card=card, seconds=seconds, steps=len(steps), losses=[st["loss"] for st in steps],
               **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9, val_allAcc=evals["allAcc"],
               val_mAcc=evals["mAcc"], val_loss=evals["loss"], eval_ms_per_batch=evals["batch_ms"],
               launches=launches, attention_fwd_per_step=fwd, attention_bwd_per_step=bwd,
               unchanged_parameters=same, parameters=sum(p.numel() for p in model.parameters()),
               stages=geometry, geometry_dropped=dropped)
    emit("cls_modelnet", **row)
    if fwd != blocks or bwd != blocks:
        raise AssertionError(f"cls_modelnet: {fwd} attention forwards and {bwd} backwards a step, {blocks} blocks")
    if same:
        raise AssertionError(f"cls_modelnet: {len(same)} parameters not updated, e.g. {same[:3]}")
    if dropped or any(g["largest_cloud"] > g["patch"] for g in geometry):
        raise AssertionError(f"cls_modelnet: geometry {geometry}, {dropped} points dropped")
    del trainer, model
    release()
    # the resumed epoch (~9 GB) runs beside the testers below
    resume = start_resume(work, CLS_CONFIG, options, os.path.join(work, "cls_modelnet"), "cls_modelnet")

    weight = os.path.join(work, "cls_modelnet", "model", "model_last.pth")
    test_options = dict(options, weight=weight, num_worker=0)
    for tag, config, extra in (("cls_test", CLS_CONFIG, {}),
                               ("cls_voting", CLS_VOTING_CONFIG, {"data.test.split": "vote"})):
        tester, result, test_launches, secs = _test_config(device, work, config, dict(test_options, **extra), tag)
        clouds = len(tester.test_dataset)
        emit(tag, config=config, card=card, seconds=secs, clouds=clouds, repeats=getattr(tester, "num_repeat", 1),
             result=result, forwards=len(tester.cloud_stats), **_cloud_stats(tester.cloud_stats),
             ms_per_cloud=secs * 1e3 / clouds, attention_launches=test_launches["patch_attention"])
        if test_launches["patch_attention"] != len(tester.cloud_stats) * blocks or not math.isfinite(result["allAcc"]):
            raise AssertionError(f"{tag}: {test_launches['patch_attention']} attention launches for "
                                 f"{len(tester.cloud_stats)} forwards, result {result}")
        del tester
        release()

    card_vs_cpu_train(device, **cvct)
    finish_resume(resume)
    return launches


def cls_tiny_path(device, card, work: str) -> dict:
    """Phase 30: the synthetic tiny classifier (head dim 4 at patch 64,
    through the D = 16 kernels on zero-padded heads) as written (2 epochs),
    then for `CLS_TINY_STEPS` steps as its convergence figure: allAcc on its
    val split against `CLS_TINY_ALLACC` (reported; the run's other limits
    held), beside the allAcc of the same weights on each val batch's own
    norm statistics. Returns the launches of both runs."""
    import torch

    from pointcept_tpu_torch.engines import make_point_batch

    total = {}
    for tag, extra in (("cls_tiny", {}), ("cls_tiny_120", dict(epoch=CLS_TINY_STEPS // 4, eval_epoch=1))):
        trainer, steps, evals, launches, peak, seconds = _run_config(device, work, CLS_TINY_CONFIG,
                                                                     dict(CLS_TINY_OPTIONS, **extra), tag)
        bb = trainer.cfg.model.backbone
        d = {c // h for c, h in zip(bb.enc_channels, bb.enc_num_head)}
        blocks = sum(bb.enc_depths)
        fwd, bwd = _attention_per_step(launches, len(steps), evals, blocks, evaluations=trainer.cfg.eval_epoch)
        row = dict(config=CLS_TINY_CONFIG, card=card, seconds=seconds, steps=len(steps), head_dims=sorted(d),
                   patch=list(bb.enc_patch_size), first_losses=[st["loss"] for st in steps[:4]],
                   last_losses=[st["loss"] for st in steps[-4:]], **_step_times(steps), peak_gb=peak / 1e9,
                   val_allAcc=evals["allAcc"], val_loss=evals["loss"], launches=launches,
                   attention_fwd_per_step=fwd, attention_bwd_per_step=bwd)
        if tag == "cls_tiny_120":
            model = trainer.model
            model.train()
            model.dropout = 0.0
            right = count = 0
            gen = torch.Generator(device=device).manual_seed(0)
            with torch.no_grad():
                for batch in trainer.val_loader:
                    pb = make_point_batch(batch, batch["num_scenes"], device=device)
                    pred = model(pb, generator=gen)["cls_logits"].argmax(-1)
                    valid = pb.category >= 0
                    right += int((pred == pb.category)[valid].sum())
                    count += int(valid.sum())
            row.update(limit=CLS_TINY_ALLACC, met=evals["allAcc"] > CLS_TINY_ALLACC,
                       batch_statistics_allAcc=right / max(count, 1))
        emit(tag, **row)
        if d != {4} or fwd != blocks or bwd != blocks:
            raise AssertionError(f"{tag}: head dims {d}, {fwd} attention forwards and {bwd} backwards a step")
        for name in ("patch_attention", "patch_attention_bwd"):
            total[name] = total.get(name, 0) + launches[name]
        del trainer
        release()
    return total


def partseg_path(device, card, work: str) -> dict:
    """Phase 31: Utonia's ShapeNet-Part fine-tune (PT-v3m3 with RoPE, head
    dim 18, widths 54-576, 9 feature channels, the config's batch of 16
    shapes) from a random encoder saved under ``student.backbone.``, on
    synthetic shapes in ShapeNet-Part's layout: 4 steps and one evaluation
    through the training CLI's `main_worker` (a later step's ms and peak,
    the D = 18 attention launches a step, the loaded and missing keys;
    limits: nothing dropped, every tensor but the mask token moved); then
    the config's ShapeNetPartSegTester on 16 test shapes, one a category.
    Returns the train run's launches."""
    import torch

    from pointcept_tpu_torch.models import build_model
    from pointcept_tpu_torch.utils.config import Config

    root = os.path.join(work, "shapenet")
    splits = write_shapenet(root)
    cfg = Config.fromfile(os.path.join(ROOT, PARTSEG_CONFIG))
    cfg.merge_from_dict(PARTSEG_OPTIONS)
    weight = os.path.join(work, "partseg_encoder.pth")
    pretrained = build_model(dict(cfg.model.backbone), device="cpu", generator=torch.Generator().manual_seed(31))
    ckpt = {"backbone." + k: v for k, v in pretrained.state_dict().items()}
    torch.save({"state_dict": {"student." + k: v for k, v in ckpt.items()}}, weight)
    del pretrained
    options = dict(PARTSEG_OPTIONS, weight=weight, **{f"data.{s}.data_root": root for s in ("train", "val", "test")})
    emit("partseg_setup", config=PARTSEG_CONFIG, options=dict(options, weight="random encoder, seed 31"),
         shapes={k: len(v) for k, v in splits.items()}, points=PARTSEG_POINTS)
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, PARTSEG_CONFIG, options,
                                                                  "partseg_utonia", TRAIN_KERNELS[:2])
    model, bb = trainer.model, trainer.cfg.model.backbone
    info = trainer.comm_info.get("load_info", {})
    blocks = sum(bb.enc_depths)
    fwd, bwd = _attention_per_step(launches, len(steps), evals, blocks)
    same, moved = _moved(model, ckpt, "backbone.")
    d = sorted({c // h for c, h in zip(bb.enc_channels, bb.enc_num_head)})
    emit("partseg_utonia", config=PARTSEG_CONFIG, card=card, seconds=seconds, head_dims=d, steps=len(steps),
         losses=[st["loss"] for st in steps], **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9,
         val_mIoU=evals["mIoU"], eval_ms_per_batch=evals["batch_ms"], launches=launches,
         attention_fwd_per_step=fwd, attention_bwd_per_step=bwd, missing_keys=info.get("missing", []),
         unexpected_keys=info.get("unexpected", []), encoder_unchanged=same, encoder_moved=len(moved),
         parameters=sum(p.numel() for p in model.parameters()))
    if set(info.get("missing", [])) != {"seg_head.weight", "seg_head.bias"}:
        raise AssertionError(f"partseg: missing keys {info.get('missing')}")
    if d != [18] or fwd != blocks or bwd != blocks:
        raise AssertionError(f"partseg: head dims {d}, {fwd} attention forwards and {bwd} backwards, {blocks} blocks")
    if [n for n in same if n != "backbone.embedding.mask_token"]:
        raise AssertionError(f"partseg: {len(same)} encoder tensors not updated, e.g. {same[:3]}")
    del trainer, model
    release()
    test_options = dict(options, num_worker=0, weight=os.path.join(work, "partseg_utonia", "model", "model_last.pth"))
    tester, result, test_launches, secs = _test_config(device, work, PARTSEG_CONFIG, test_options, "partseg_test")
    stats = tester.scene_stats
    emit("partseg_test", config=PARTSEG_CONFIG, card=card, seconds=secs, shapes=len(stats), result=result,
         ms_per_shape=secs * 1e3 / len(stats), median_scene_ms=statistics.median(st["scene_ms"] for st in stats),
         fragments=[st["fragments"] for st in stats], dropped=sum(st["dropped"] for st in stats),
         attention_launches=test_launches["patch_attention"])
    if (len(stats) != PARTSEG_SPLITS["test"] or not math.isfinite(result["ins_miou"])
            or test_launches["patch_attention"] == 0):
        raise AssertionError(f"partseg test: {len(stats)} shapes, result {result}, launches {test_launches}")
    del tester
    release()
    return launches


def _surface(rng, kind: int, n: int, center, size):
    """n points on one primitive's surface (0 sphere, 1 box, 2 cylinder)
    with their outward normals."""
    import numpy as np

    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    if kind == 0:
        pts, nrm = d, d
    elif kind == 1:
        axis = np.abs(d).argmax(axis=1)
        pts = rng.uniform(-1, 1, (n, 3))
        sign = np.sign(d[np.arange(n), axis])
        pts[np.arange(n), axis] = sign
        nrm = np.zeros((n, 3))
        nrm[np.arange(n), axis] = sign
    else:
        theta = rng.uniform(0, 2 * np.pi, n)
        pts = np.stack([np.cos(theta), np.sin(theta), rng.uniform(-1, 1, n)], axis=1)
        nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], axis=1)
    nrm = nrm / np.asarray(size)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True) + 1e-9
    return pts * np.asarray(size) + np.asarray(center), nrm


def _shape(class_seed: int, sample_seed: int, points: int, parts: int):
    """A class's shape: `parts` primitives whose kinds, places and sizes
    come from ``RandomState(class_seed)``, each sample's jittered from
    ``RandomState(sample_seed)``; [points, 6] rows of xyz and normal and
    each point's part."""
    import numpy as np

    layout = np.random.RandomState(class_seed)
    kinds = layout.randint(0, 3, parts)
    centers = layout.uniform(-0.6, 0.6, (parts, 3))
    sizes = layout.uniform(0.15, 0.5, (parts, 3))
    rng = np.random.RandomState(sample_seed)
    part = rng.randint(0, parts, points)
    rows = np.zeros((points, 6))
    for p in range(parts):
        sel = part == p
        size = sizes[p] * rng.uniform(0.9, 1.1, 3)
        center = centers[p] + rng.normal(0, 0.03, 3)
        pts, nrm = _surface(rng, kinds[p], int(sel.sum()), center, size)
        rows[sel] = np.concatenate([pts, nrm], axis=1)
    return rows, part


def write_modelnet(root: str, names, splits=CLS_SPLITS, points: int = CLS_FILE_POINTS) -> dict:
    """Synthetic clouds in ModelNet40's `modelnet40_normal_resampled` layout:
    ``<class>/<class>_<i>.txt`` (x, y, z, nx, ny, nz comma-separated),
    ``modelnet40_{split}.txt`` and ``modelnet40_shape_names.txt``; cloud i
    of each split is of class ``i % len(names)``, a class's shape three
    primitives of its own layout. Returns each split's names."""
    import numpy as np

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("".join(f"{n}\n" for n in names))
    lists, count = {}, {}
    line = ",".join(["%.6f"] * 6) + "\n"  # one format of the whole file: savetxt's rows, twice as fast
    for split, n in splits.items():
        lists[split] = []
        for i in range(n):
            c = i % len(names)
            count[c] = count.get(c, 0) + 1
            name = f"{names[c]}_{count[c]:04d}"
            rows, _ = _shape(c, 1000 * c + count[c], points, 3)
            os.makedirs(os.path.join(root, names[c]), exist_ok=True)
            with open(os.path.join(root, names[c], name + ".txt"), "w") as f:
                f.write((line * len(rows)) % tuple(rows.ravel()))
            lists[split].append(name)
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("".join(f"{n}\n" for n in lists[split]))
    return lists


def write_shapenet(root: str, splits=PARTSEG_SPLITS, points: int = PARTSEG_POINTS) -> dict:
    """Synthetic shapes in ShapeNet-Part's layout: ``<synset>/<id>.txt`` rows
    of x y z nx ny nz part, ``synsetoffset2category.txt`` and
    ``train_test_split/shuffled_{split}_file_list.json``; shape i of each
    split is of category ``i % 16``, each of its primitives one of the
    category's parts (the standard 50-part ranges)."""
    import numpy as np

    from pointcept_tpu_torch.datasets.shapenet_part import ShapeNetPartDataset as SN

    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        f.write("".join(f"{c}\t{s}\n" for c, s in SHAPENET_SYNSETS.items()))
    lists = {}
    for split, n in splits.items():
        lists[split] = []
        for i in range(n):
            cat = SN.categories[i % len(SN.categories)]
            parts = SN.category2part[cat]
            syn = SHAPENET_SYNSETS[cat]
            rows, part = _shape(100 + i % 16, 10000 * (1 + list(splits).index(split)) + i, points, len(parts))
            sid = f"{split}{i:04d}"
            os.makedirs(os.path.join(root, syn), exist_ok=True)
            np.savetxt(os.path.join(root, syn, sid + ".txt"),
                       np.concatenate([rows, np.asarray(parts)[part][:, None]], axis=1), fmt="%.6f")
            lists[split].append(f"shape_data/{syn}/{sid}")
        with open(os.path.join(root, "train_test_split", f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(lists[split], f)
    return lists


def ptv2_step_checks(trainer, device) -> dict:
    """Phase 32's checks on the trained model and a batch of its train set:
    two steps' forward and backward from one state and one generator seed
    (the same loss and gradient bits), then one forward with each kNN timed
    alone (the card synchronised around it) and each GridPool's clusters
    against its capacity."""
    import torch

    from pointcept_tpu_torch.datasets import point_collate_fn
    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models.point_transformer_v2 import point_transformer_v2 as ptv2

    model, cfg = trainer.model, trainer.cfg
    ds = trainer.train_loader.dataset
    batch = point_collate_fn([ds[i] for i in range(cfg.batch_size)], capacity=cfg.point_capacity)
    pb = make_point_batch(batch, batch["num_scenes"], device=device)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        model.train()
        res = model(pb, generator=torch.Generator(device=device).manual_seed(7))
        res["loss"].backward()
        runs.append([res["loss"].detach()] + [p.grad.clone() for p in model.parameters() if p.grad is not None])
    same_bits = len(runs[0]) == len(runs[1]) and all(torch.equal(a, b) for a, b in zip(*runs))
    del runs

    knn, pools = [], []
    query = ptv2.knn_query

    def timed(k, coord, batch_ids, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = query(k, coord, batch_ids, *args, **kw)
        torch.cuda.synchronize()
        knn.append(dict(k=k, rows=int(coord.shape[0]), ms=(time.perf_counter() - t0) * 1e3))
        return out

    def count(module, inputs, output):
        pooled, _, _, dropped = output
        pools.append(dict(capacity=int(pooled.batch.shape[0]), clusters=int((pooled.batch >= 0).sum()),
                          dropped=int(dropped)))

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, ptv2.GridPool)]
    ptv2.knn_query = timed
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(pb, generator=torch.Generator(device=device).manual_seed(7))
            torch.cuda.synchronize()
            forward_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ptv2.knn_query = query
        for h in hooks:
            h.remove()
    model.load_state_dict(state)
    return dict(two_steps_same_bits=same_bits, knn_calls=knn, knn_ms=sum(c["ms"] for c in knn),
                timed_forward_ms=forward_ms, pools=pools, points=int((pb.batch >= 0).sum()))


def ptv2_path(device, card, work: str) -> dict:
    """Phase 32: the ScanNet PT-v2m2 config through the training CLI's
    `main_worker` at full width on phase 10's scenes (one 4-step epoch and
    its evaluation), the step checks of `ptv2_step_checks`, every trainable
    tensor moved; then its test section through the test CLI's
    `main_worker` on one val scene (every point voted by every view)."""
    data_root = os.path.join(work, "scannet")
    options = dict(DOWNSTREAM_OPTIONS, **{"data.train.data_root": data_root, "data.val.data_root": data_root})
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, PTV2_CONFIG, options, "ptv2")
    same, moved = _moved_from_init(trainer, device)
    checks = _quiet(lambda: ptv2_step_checks(trainer, device), os.path.join(work, "trainer.log"))
    times = _step_times(steps)
    emit("ptv2", config=PTV2_CONFIG, options=options, card=card, seconds=seconds,
         parameters=sum(p.numel() for p in trainer.model.parameters()), steps=len(steps),
         losses=[st["loss"] for st in steps], **times, peak_memory_bytes=peak, peak_gb=peak / 1e9,
         val_mIoU=evals["mIoU"], eval_ms_per_scene=evals["batch_ms"], unchanged_parameters=same,
         moved_parameters=len(moved), knn_share_of_step=checks["knn_ms"] / times["later_median_step_ms"],
         launches=launches, **checks)
    if same:
        raise AssertionError(f"ptv2: {len(same)} parameters not updated, e.g. {same[:3]}")
    if not checks["two_steps_same_bits"]:
        raise AssertionError("ptv2: two steps from one state gave different loss or gradient bits")
    if len(checks["pools"]) != 4 or any(p["dropped"] or p["clusters"] > p["capacity"] for p in checks["pools"]):
        raise AssertionError(f"ptv2: GridPool dropped points: {checks['pools']}")
    del trainer
    release()

    test_root = os.path.join(work, "ptv2_test_data")
    raw = write_scannet_scene(test_root, "val", int(PROBE_TEST_SCENE[5:9]), PTV2_TEST_POINTS)
    options = dict(TESTER_OPTIONS, point_capacity_test=PTV2_TEST_CAPACITY, num_worker=0,
                   weight=os.path.join(work, "ptv2", "model", "model_last.pth"),
                   **{"data.test.data_root": test_root})
    st = test_scene(device, card, work, "ptv2_test", PTV2_CONFIG, PROBE_TEST_SCENE, raw, options, kernels=())
    return dict(step_ms=times["later_median_step_ms"], peak_gb=peak / 1e9, knn_ms=checks["knn_ms"],
                test_scene_ms=st["scene_ms"])


def ptv2_card_vs_cpu(device):
    """Phase 33: PT-v2m2 and PT-v2m1 (grouped linear, position multiplier)
    at one block a stage, f32: the logits, then one train step (loss and
    every gradient), on the card against the CPU, on the PTV2_SCENE scene."""
    for logits, train in ptv2_cvc():
        card_vs_cpu(device, **logits)
        card_vs_cpu_train(device, **train)


def ptv2_cvc() -> list:
    """Phase 33's (`card_vs_cpu`, `card_vs_cpu_train`) arguments, m2 then m1."""
    capacity, extent = PTV2_SCENE
    out = []
    for kw, tag in (({}, "m2"), (dict(type="PT-v2m1", pe_multiplier=True), "m1")):
        cfg = dict(type="DefaultSegmentor", backbone=dict(PTV2_SMALL, **kw),
                   criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
        out.append((dict(cases=[(False, cfg)], phase=f"ptv2_{tag}_card_vs_cpu", capacity=capacity, extent=extent),
                    dict(cases=[(False, cfg, PTV2_RECIPE)], phase=f"ptv2_{tag}_card_vs_cpu_train", capacity=capacity,
                         extent=extent, vanishing_below=1e-4)))
    return out


def cac_path(device, card, work: str) -> dict:
    """Phase 34: the Context-Aware Classifier's ScanNet configs over SpUNet
    and over PT-v2m2 through the training CLI's `main_worker` at phase 14's
    cuts: each step's four loss terms finite, the step ms and the peak."""
    data_root = os.path.join(work, "scannet")
    out = {}
    for tag, config, extra in CAC_CONFIGS:
        options = dict(DOWNSTREAM_OPTIONS, **extra,
                       **{"data.train.data_root": data_root, "data.val.data_root": data_root})
        trainer, steps, evals, launches, peak, seconds = _run_config(device, work, config, options, tag)
        rows = _metrics(os.path.join(work, tag))
        terms = {k: [r[k] for r in rows] for k in CAC_LOSSES}
        emit(tag, config=config, options=options, card=card, seconds=seconds,
             parameters=sum(p.numel() for p in trainer.model.parameters()), steps=len(steps),
             losses=[st["loss"] for st in steps], loss_terms=terms, **_step_times(steps), peak_memory_bytes=peak,
             peak_gb=peak / 1e9, val_mIoU=evals["mIoU"], eval_ms_per_scene=evals["batch_ms"], launches=launches)
        if not all(len(v) == len(steps) and all(math.isfinite(x) for x in v) for v in terms.values()):
            raise AssertionError(f"{tag}: loss terms {terms}")
        out[tag] = dict(steps=len(steps), peak_gb=peak / 1e9)
        del trainer
        release()
    return out


def _moved_from_init(trainer, device) -> tuple:
    """(names of the trainer's parameters still at their seeded init, of
    those that moved): the config's model built again from its seed."""
    import torch

    from pointcept_tpu_torch.models import apply_amp_policy, build_model

    cfg = trainer.cfg
    initial = build_model(apply_amp_policy(dict(cfg.model), cfg.get("enable_amp", False)), device=device,
                          generator=torch.Generator().manual_seed(cfg.shared_seed))
    same, moved = _moved(trainer.model, {n: p.detach().cpu() for n, p in initial.named_parameters()})
    del initial
    return same, moved


def rpe_path(device, card, work: str, rooms: dict) -> dict:
    """Phase 35: the S3DIS RPE config through the training CLI's
    `main_worker` on phase 17's offices (`rooms`: their voxel counts) at
    phase 14's cuts: a later step's ms, data time and peak; 22 biased
    attention forwards and backwards a step on their own counters and no
    unbiased launch; the fill and the take-back launched (the block
    engine); every tensor moved, each block's `rpe_table` among them;
    nothing dropped at any pooling. Returns the launches."""
    root = os.path.join(work, "s3dis")
    val = rooms["Area_5/office_1"]["2cm"]
    options = dict(RPE_OPTIONS, point_capacity_val=-(-val // 4096) * 4096 + 4096,
                   **{"data.train.data_root": root, "data.val.data_root": root})
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, RPE_CONFIG, options, "rpe",
                                                                  RPE_KERNELS)
    same, moved = _moved_from_init(trainer, device)
    tables = [n for n, _ in trainer.model.named_parameters() if n.endswith("attn.rpe.rpe_table")]
    bb = trainer.cfg.model.backbone
    blocks = sum(bb.enc_depths) + sum(bb.dec_depths)
    fwd = (launches["patch_attention_rpe"] - len(evals["batch_ms"]) * blocks) / len(steps)
    bwd = launches["patch_attention_rpe_bwd"] / len(steps)
    emit("rpe", config=RPE_CONFIG, options=options, card=card, seconds=seconds,
         parameters=sum(p.numel() for p in trainer.model.parameters()), steps=len(steps),
         losses=[st["loss"] for st in steps], **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9,
         val_mIoU=evals["mIoU"], eval_ms_per_scene=evals["batch_ms"], launches=launches,
         rpe_fwd_per_step=fwd, rpe_bwd_per_step=bwd, rpe_tables=len(tables),
         rpe_tables_moved=sum(n in moved for n in tables), unchanged_parameters=same)
    if fwd != blocks or bwd != blocks or blocks != 22:
        raise AssertionError(f"rpe: {fwd} biased attention forwards and {bwd} backwards a step, {blocks} blocks")
    if launches["patch_attention"] or launches["patch_attention_bwd"]:
        raise AssertionError(f"rpe: unbiased attention launched: {launches}")
    if same or len(tables) != blocks:
        raise AssertionError(f"rpe: {len(same)} parameters not updated, e.g. {same[:3]}; {len(tables)} tables")
    del trainer
    release()
    return launches


def litept_path(device, card, work: str) -> dict:
    """Phases 36-37: LitePT-v1 at the class defaults through the ScanNet
    LitePT config's recipe and the training CLI's `main_worker` on phase
    10's scenes at phase 14's cuts: a later step's ms, data time and peak,
    8 attention forwards and backwards a step (head dim 18), every tensor
    moved, nothing dropped at any pooling; then its test section through
    the test CLI's `main_worker` on one val scene (every point voted by
    every view). Returns the launches of the train run."""
    data_root = os.path.join(work, "scannet")
    # (a fresh copy each time: parsing a config pops the `_delete_` of its options)
    options = dict(DOWNSTREAM_OPTIONS, **copy.deepcopy(LITEPT_OPTIONS),
                   **{"data.train.data_root": data_root, "data.val.data_root": data_root})
    trainer, steps, evals, launches, peak, seconds = _run_checked(device, work, LITEPT_CONFIG, options, "litept",
                                                                  ("patch_attention", "patch_attention_bwd"))
    same, moved = _moved_from_init(trainer, device)
    bb = trainer.model.backbone
    blocks = sum(1 for m in bb.modules() if hasattr(m, "attn"))
    fwd, bwd = _attention_per_step(launches, len(steps), evals, blocks)
    emit("litept", config=LITEPT_CONFIG, options=options, card=card, seconds=seconds,
         parameters=sum(p.numel() for p in trainer.model.parameters()), steps=len(steps),
         losses=[st["loss"] for st in steps], **_step_times(steps), peak_memory_bytes=peak, peak_gb=peak / 1e9,
         val_mIoU=evals["mIoU"], eval_ms_per_scene=evals["batch_ms"], launches=launches,
         attention_fwd_per_step=fwd, attention_bwd_per_step=bwd, head_dims=sorted({
             m.attn.qkv.in_features // m.attn.num_heads for m in bb.modules() if hasattr(m, "attn")}),
         unchanged_parameters=same, optimizer_groups=len(trainer.optimizer.param_groups))
    if fwd != blocks or bwd != blocks or blocks != 8:
        raise AssertionError(f"litept: {fwd} attention forwards and {bwd} backwards a step, {blocks} blocks")
    if same:
        raise AssertionError(f"litept: {len(same)} parameters not updated, e.g. {same[:3]}")
    del trainer
    release()

    test_root = os.path.join(work, "litept_test_data")
    raw = write_scannet_scene(test_root, "val", int(PROBE_TEST_SCENE[5:9]), LITEPT_TEST_POINTS)
    options = dict(TESTER_OPTIONS, **copy.deepcopy(LITEPT_OPTIONS), point_capacity_test=LITEPT_TEST_CAPACITY,
                   num_worker=0,
                   weight=os.path.join(work, "litept", "model", "model_last.pth"),
                   **{"data.test.data_root": test_root})
    test_scene(device, card, work, "litept_test", LITEPT_CONFIG, PROBE_TEST_SCENE, raw, options,
               kernels=("patch_attention",))
    return launches


def small_card_vs_cpu(device):
    """Phase 38: LitePT at the class widths and PT-v3m1 with RPE at patch
    128, one block a stage, f32: the logits, then one train step (loss and
    every gradient), on the card against the CPU on a SMALL_SCENE scene."""
    for logits, train in small_cvc():
        card_vs_cpu(device, **logits)
        card_vs_cpu_train(device, **train)


def small_cvc() -> list:
    """Phase 38's (`card_vs_cpu`, `card_vs_cpu_train`) arguments, LitePT then RPE."""
    capacity, extent = SMALL_SCENE
    criteria = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
                dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
    litept = dict(MODEL, backbone_out_channels=72, backbone=LITEPT_SMALL, criteria=criteria)
    rpe = dict(MODEL, backbone=dict(_small_ptv3(False), enable_rpe=True, enc_patch_size=(128,) * 5,
                                    dec_patch_size=(128,) * 4, drop_path=0.0, pool_capacity_factors=(1.0,) * 4,
                                    conv_engine="gather"))
    rpe_train = dict(TRAIN_MODEL, backbone=dict(rpe["backbone"], shuffle_orders=True))
    return [(dict(cases=[(False, cfg)], phase=f"{tag}_card_vs_cpu", capacity=capacity, extent=extent),
             dict(cases=[(False, train_cfg, PTV3_RECIPE)], phase=f"{tag}_card_vs_cpu_train", capacity=capacity,
                  extent=extent))
            for tag, cfg, train_cfg in (("litept", litept, litept), ("rpe", rpe, rpe_train))]


def _phases(device, card, build) -> tuple:
    """Phases 2-38, each timed by `_phase_runner`; returns what the kernels
    line reads."""
    build_seconds = _build(build)
    phase = _phase_runner()
    kernels = phase("3-4 kernels", kernel_cases, device, scene(1000))
    phase("5 serving", main_path, device, card)
    phase("6 card_vs_cpu", card_vs_cpu, device)
    launches, bare_step_ms = phase("7 train", train_path, device, card)
    # at a quarter of the scene (4,096 points, 1.2 m, the density of 2.4 m at
    # 16,384), as SpUNet's and phase 26's: the time limit's room for phases 29-31
    # (8,192 at 1.7 m before)
    phase("8 card_vs_cpu_train", card_vs_cpu_train, device, **PHASE8_CVCT)

    phase("9 spunet_serving", main_path, device, card, SPUNET_MODEL, SPUNET_EVAL_KERNELS, phase="spunet_serving")
    phase("9 spunet_card_vs_cpu", card_vs_cpu, device, **SPUNET_CVC)
    spunet, _ = phase("9 spunet_train", train_path, device, card, SPUNET_MODEL, SPUNET_RECIPE,
                      SPUNET_TRAIN_KERNELS, phase="spunet_train_path")
    phase("9 spunet_card_vs_cpu_train", card_vs_cpu_train, device, **SPUNET_CVCT)
    launches.update({name: spunet[name] for name in ("tap_conv_fwd", "tap_conv_dw")})

    work = os.path.join(ROOT, "build", "chip_smoke_trainer")
    shutil.rmtree(work, ignore_errors=True)
    try:
        trainer_resume = phase("10 trainer", trainer_path, device, card, work, bare_step_ms)
        phase("11 tester", tester_path, device, card, work)
        phase("12 overfit", overfit_runs, device, card, work)
        phase("10 trainer_resume (beside 11-12)", finish_resume, trainer_resume)
        sonata_resume = phase("13 sonata", sonata_path, device, card, work)
        phase("14 downstream", downstream_path, device, card, work)
        utonia = phase("15 utonia", utonia_path, device, card, work)
        phase("16 scannet200", scannet200_path, device, card, work)
        sonata_resume = start_resume(*sonata_resume)
        rooms = phase("17 s3dis", s3dis_path, device, card, work)
        phase("13 sonata_resume (beside 17)", finish_resume, sonata_resume)
        phase("18 scannetpp", scannetpp_path, device, card, work)
        phase("19 lora", lora_path, device, card, work)
        outdoor = [phase("20 kitti", kitti_path, device, card, work),
                   phase("21 nuscenes", nuscenes_path, device, card, work),
                   phase("22 waymo", waymo_path, device, card, work)]
        probes = phase("23 outdoor_probes", outdoor_probe_path, device, card, work)
        ppt = phase("24 ppt_extreme", ppt_path, device, card, work, PPT_CONFIG, "ppt_extreme", s3d_rooms=4,
                    test=True)
        phase("24 ppt_card_vs_cpu", ppt_card_vs_cpu, device)
        phase("25 ppt_spunet", ppt_path, device, card, work, PPT_SPUNET_CONFIG, "ppt_spunet", s3d_rooms=3,
              test=False)
        insseg = phase("26 insseg", insseg_ptv3_path, device, card, work)
        phase("27 insseg_overfit", insseg_overfit_path, device, card, work)
        insseg_probe = phase("28 insseg_probe", insseg_probe_path, device, card, work)
        cls = phase("29 cls_modelnet", cls_modelnet_path, device, card, work)
        tiny = phase("30 cls_tiny", cls_tiny_path, device, card, work)
        partseg = phase("31 partseg", partseg_path, device, card, work)
        phase("32 ptv2", ptv2_path, device, card, work)
        phase("33 ptv2_card_vs_cpu", ptv2_card_vs_cpu, device)
        phase("34 cac", cac_path, device, card, work)
        rpe = phase("35 rpe", rpe_path, device, card, work, rooms)
        litept = phase("36-37 litept", litept_path, device, card, work)
        phase("38 small_card_vs_cpu", small_card_vs_cpu, device)
    finally:
        for run in list(_RESUMES):  # a phase failed: its resume children go
            run["proc"].kill()
            run["proc"].communicate()
            _RESUMES.remove(run)
        shutil.rmtree(work, ignore_errors=True)
    emit("phase_seconds_all", seconds=phase.seconds, phases_1_34=sum(
        v for k, v in phase.seconds.items() if int(k.split()[0].split("-")[0]) <= 34) + build_seconds)
    return kernels, launches, utonia, probes, partseg, tiny, outdoor, ppt, insseg, insseg_probe, cls, rpe, litept


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "pointcept_tpu_torch")):
        print(f"chip_smoke: no pointcept_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pointcept_tpu_torch.ops.kernels import build

    device = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    cap = torch.cuda.get_device_capability(device)
    cores = len(os.sched_getaffinity(0))
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, card=card, capability=list(cap), cores=cores,
         torch_threads=torch.get_num_threads(), cpu_worker_threads=max(1, cores // 2))
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")

    # the CPU sides of the card-vs-CPU phases, ahead of them in a worker of
    # half the cores, from before the build (they need no kernel)
    start_cpu_worker(max(1, cores // 2))
    finished = False
    try:
        cpu_prefetch(static_cpu_jobs())
        out = _phases(device, card, build)
        finished = True
    finally:
        stop_cpu_worker(finished)
    kernels, launches, utonia, probes, partseg, tiny, outdoor, ppt, insseg, insseg_probe, cls, rpe, litept = out
    _kernels_line(card, kernels, launches, utonia, probes, partseg, tiny, outdoor, ppt, insseg, insseg_probe, cls,
                  rpe, litept)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


def _build(build) -> float:
    """Phase 2: every kernel library, one nvcc a source in parallel; returns
    the seconds since the start."""
    t0 = time.perf_counter()
    logs = build.build_all(["patch_attention", "patch_attention_bwd", "patch_attention_rpe", "patch_attention_bwd_rpe",
                            "block_fill", "take_back", "tap_conv"])
    build.load_host("clustering")  # PointGroup's host BFS (g++), built before any phase times it
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)
    return time.perf_counter() - _START


def _kernels_line(card, kernels, launches, utonia, probes, partseg, tiny, outdoor, ppt, insseg, insseg_probe, cls,
                  rpe, litept) -> None:
    """The {"kernels": [...]} line (phase 39), after the card's name and power limit."""
    sources = {"patch_attention": "pointcept_tpu_torch/csrc/patch_attention.cu",
               "patch_attention_bwd": "pointcept_tpu_torch/csrc/patch_attention_bwd.cu",
               "block_fill": "pointcept_tpu_torch/csrc/block_fill.cu",
               "take_back": "pointcept_tpu_torch/csrc/take_back.cu",
               "tap_conv_fwd": "pointcept_tpu_torch/csrc/tap_conv.cu",
               "tap_conv_dw": "pointcept_tpu_torch/csrc/tap_conv.cu"}
    replaces = {
        "patch_attention": "pointcept_tpu/ops/pallas/flash_attention.py:206 "
                           "(_fwd_kernel_kmajor; also _fwd_kernel at :51)",
        "patch_attention_bwd": "pointcept_tpu/ops/pallas/flash_attention.py:281 "
                               "(_bwd_kernel_kmajor_chunked; also _bwd_kernel_kmajor at :238, "
                               "_bwd_kernel_chunked at :113, _bwd_kernel at :66)",
        "block_fill": "pointcept_tpu/ops/pallas/block_fill.py:40",
        "take_back": "pointcept_tpu/ops/pallas/layout_pin.py:30",
        "tap_conv_fwd": "pointcept_tpu/ops/pallas/tap_conv.py:168 "
                        "(_conv_kernel_banded; also _conv_kernel_sliced at :175, via tap_conv at :204)",
        "tap_conv_dw": "pointcept_tpu/ops/pallas/tap_conv.py:268 "
                       "(_dw_kernel_banded; also _dw_kernel_sliced at :286, via tap_conv_dw at :310)",
    }
    # the D = 18 rows: the same kernels at Utonia's head dim (padded to 24),
    # launched by phase 15's fine-tune
    for name in ("patch_attention", "patch_attention_bwd"):
        sources[f"{name}[D=18]"], replaces[f"{name}[D=18]"] = sources[name], replaces[name]
        # phase 31's part-seg fine-tune at D = 18 too
        launches[f"{name}[D=18]"] = utonia[name] + probes["utonia_4c"][name] + partseg[name]
        # the D = 4 rows: the same kernels at the tiny classifier's head dim (padded to 16), phase 30
        sources[f"{name}[D=4]"], replaces[f"{name}[D=4]"] = sources[name], replaces[name]
        launches[f"{name}[D=4]"] = tiny[name]
        # phases 20-23 at D = 16: the outdoor PTv3 configs' train runs and Concerto's probe;
        # phase 24's PPT-extreme run, phases 26 and 28's, phase 29's classifier
        launches[name] += (sum(run["trainer"][name] for run in outdoor) + probes["concerto_4a"][name]
                           + ppt[name] + insseg[name] + insseg_probe[name] + cls[name])
    for name in ("block_fill", "take_back"):
        launches[name] += ppt[name]
    # LitePT's attention stages at D = 18 (phase 36)
    for name in ("patch_attention", "patch_attention_bwd"):
        launches[f"{name}[D=18]"] += litept[name]
    # the biased (RPE) rows: the same two sources with the score bias, launched by phase 35
    for name, base, source in (("patch_attention_rpe", "patch_attention", "patch_attention_rpe.cu"),
                               ("patch_attention_rpe_bwd", "patch_attention_bwd", "patch_attention_bwd_rpe.cu")):
        sources[name] = f"pointcept_tpu_torch/csrc/{source}"
        replaces[name] = replaces[base] + " with a score bias, which the TPU kernels do not take"
        launches[name] = rpe[name]
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in kernels.items()
    ]}
    print(card)
    print(json.dumps(line))


if __name__ == "__main__":
    sys.exit(main())
