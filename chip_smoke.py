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
   forward at every stage's shapes of the eval forward and the train step,
   the backward at the train step's (K 1024) and, for the TPU's whole-K
   kernels, at K 128, both run twice at stage 0 and bit-identical; the
   fill and the take-back at 4^3 and 8^3
   blocks, the two as each other's VJP (`BlockFill`, `TakeBack` backward
   passes) in the sorted and the shuffled route and SpUNet's, the fused
   block conv (`tap_conv_fwd` forward and as the input gradient,
   `tap_conv_dw`) at PTv3's stage 0 and stem and SpUNet's levels 0 and 3
   and stem, and the gather conv's VJP; `tap_conv_dw` and the gather conv's
   VJP run twice and must be bit-identical;
4. times: kernel, plain version, one PyTorch library call computing the same
   function, and the least time the card could take (bound); the attention
   rows with their launches per forward or step, and each path's sum of
   launches x ms;
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
10. one {"kernels": [...]} line (launches: the training paths', PTv3's for
   its four kernels and SpUNet's for the fused block conv's two).

The last line is {"ok": true, "device": {...}}. Any failure raises and exits
nonzero; nothing falls back to the CPU. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
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
# small depth for the card-vs-CPU phases: one block a stage, the block engine
# from 4,096 points (levels 0-2 of a 16,384-point scene)
SPUNET_SMALL = dict(SPUNET, layers=(1,) * 8, block_engine_min_points=4096)
# card-vs-CPU bounds of one train step (tests/test_torch_port_train.py):
# loss relative error, per-tensor gradient relative L2 error, cosine; the
# gradient bounds widen to twice the run's own noise floor (phase 8)
TRAIN_BOUNDS = {False: (2e-2, 5e-2, 0.999), True: (1e-1, 1.5e-1, 0.99)}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def scene(seed, capacity: int = CAPACITY, extent: float = 6.0, labelled: bool = False):
    """Collated ScanNet-like synthetic scenes at 0.02 m (numpy): the
    repository's benchmark scene (a 6 m room, 4x oversampled, center-cropped
    to `capacity` points), one per seed (`seed` an int or a tuple of seeds),
    labels dropped unless `labelled`."""
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


def paired_ms(fn, library, rounds: int = 5, hold: int = 10_000_000) -> dict:
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


def _patches(capacity: int, stage: int, num_scenes: int, k: int = 1024) -> int:
    """Patches of one stage: the model's static pooled capacity, padded."""
    cap = capacity
    for f in BACKBONE["pool_capacity_factors"][:stage]:
        cap = -(-max(math.ceil(cap * f), 128) // 128) * 128
    return -(-cap // k) + num_scenes  # padded_capacity / K


def kernel_cases(device, arrays):
    """Phase 3 and 4: every kernel against its plain version, then timed.
    Returns {kernel: dict of the numbers of its main-path case}."""
    import torch

    from pointcept_tpu_torch.ops.kernels import block_fill, block_fill_plain, take_back_rows, take_back_rows_plain

    gen = torch.Generator(device=device).manual_seed(0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    exp_rate = EXP_PER_CLOCK_PER_SM * sms * clock_hz
    results = {}

    # A. attention, forward and backward (D in the function below)
    results.update(attention_cases(device, gen, exp_rate))
    pb, t = stage0_tables(arrays, device)

    # B. block fill at the stem (Cin=6) and the first convs (Cin=32), and
    # C. the take-back of a conv output (Cout=32): PTv3's stage-0 tables (4^3
    # blocks) and SpUNet's level-0 tables (8^3 blocks) of the real scene
    levels = spunet_geometry(arrays, device)
    for model, tables in (("PTv3", t), ("SpUNet", levels[0]["nbr"])):
        b3 = 1 << (3 * tables["block_bits"])
        rc, starts = tables["rc_sorted"], tables["fill_start"]
        ok = rc >= 0
        nvalid = int(ok.sum())
        m = starts.shape[0]
        for cin in (6, 32):
            feat = (pb.feat if cin == 6 else torch.randn((pb.capacity, cin), generator=gen, device=device))
            feat = feat.to(torch.bfloat16).contiguous()
            got = block_fill(feat, rc, starts, b3)
            want = block_fill_plain(feat, rc, starts, b3)
            torch.cuda.synchronize()
            err = check_close(f"block_fill[{model},b3={b3},Cin={cin}]", got, want, atol=0.0, rtol=0.0)
            idx, vals = rc[ok].long(), feat[ok]
            row = dict(
                shape=dict(model=model, N=pb.capacity, valid=nvalid, m=m, b3=b3, Cin=cin), max_abs_err=err,
                ms=time_ms(lambda: block_fill(feat, rc, starts, b3)),
                plain_ms=time_ms(lambda: block_fill_plain(feat, rc, starts, b3)),
                library_ms=time_ms(lambda: torch.zeros(((m + 1) * b3, cin), dtype=feat.dtype,
                                                       device=device).index_put_((idx,), vals)),
            )
            bytes_ = nvalid * cin * 2 + pb.capacity * 4 + m * 4 + (m + 1) * b3 * cin * 2
            row["bound_ms"] = bytes_ / PEAK_BYTES * 1e3
            row["bound_by"] = "bytes"
            emit("time", kernel="block_fill", library="zeros + index_put_", **_named(row))
            if cin == 32 and model == "PTv3":
                results["block_fill"] = row

        slot = tables["slot"]
        dense = torch.randn(((m + 1) * b3, 32), generator=gen, device=device).to(torch.bfloat16)
        got = take_back_rows(dense, slot)
        want = take_back_rows_plain(dense, slot)
        torch.cuda.synchronize()
        err = check_close(f"take_back_rows[{model},b3={b3},C=32]", got, want, atol=0.0, rtol=0.0)
        slot_l = slot.long()
        row = dict(
            shape=dict(model=model, N=slot.shape[0], R=dense.shape[0], C=32), max_abs_err=err,
            ms=time_ms(lambda: take_back_rows(dense, slot)),
            plain_ms=time_ms(lambda: take_back_rows_plain(dense, slot)),
            library_ms=time_ms(lambda: torch.index_select(dense, 0, slot_l)),
        )
        n = slot.shape[0]
        row["bound_ms"] = (n * 32 * 2 * 2 + n * 4) / PEAK_BYTES * 1e3
        row["bound_by"] = "bytes"
        emit("time", kernel="take_back", library="torch.index_select", **_named(row))
        if model == "PTv3":
            results["take_back"] = row

    # E. the fill and the take-back as each other's VJP, in the sorted route
    # (the eval forward's tables), the shuffled one (tables re-sorted by z)
    # and SpUNet's (8^3 blocks)
    vjp_cases(device, arrays, gen, levels[0]["nbr"])

    # F. the fused block conv, G. the gather conv's VJP
    results.update(tap_conv_cases(device, t, levels, gen))
    gather_vjp_case(device, spunet_geometry(arrays, device, backbone=dict(SPUNET, conv_engine="gather"))[1]["nbr"],
                    gen)
    return results


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
    forward and the train backward at stage 0's encoder width."""
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
    for path, scenes, stage, c, h, launches in cases:
        kk_ = k if stage is not None else 128
        np_ = _patches(scenes * CAPACITY, stage, scenes) if stage is not None else scenes * CAPACITY // 128 + 2
        d = c // h
        scale = d**-0.5
        shape = dict(path=path, stage=stage, nP=np_, K=kk_, C=c, H=h, pairs=np_ * h)
        label = f"{path},stage={stage},C={c},K={kk_}"
        qkv = torch.randn((np_, kk_, 3 * c), generator=gen, device=device).to(torch.bfloat16)
        q, kk, v = (qkv.view(np_, kk_, 3, h, d)[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        per = "launches_per_forward" if path == "eval" else "launches_per_step"
        kernels = ("fwd",) if path == "eval" else ("fwd", "bwd") if stage is not None else ("bwd",)
        stats = path != "eval"
        out, m_, l_ = patch_attention_fwd(qkv, h, scale, stats=True)
        for kern in kernels:
            if kern == "fwd":
                got = patch_attention_fwd(qkv, h, scale, stats=stats)
                want = patch_attention_fwd_plain(qkv, h, scale, stats=stats)
                torch.cuda.synchronize()
                # bf16 output rounding (one ulp is 2^-8 relative) plus exp and summation order
                err = check_close(f"patch_attention[{label}]", got[0] if stats else got,
                                  want[0] if stats else want, atol=2e-2, rtol=2e-2)
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
                if path == "train" and stage == 0 and c == BACKBONE["enc_channels"][0]:
                    identical_checks(qkv, out, dout, m_, l_, h, scale, got)
            exps = np_ * h * kk_ * kk_
            row["bound_ms"] = max(bytes_ / PEAK_BYTES, exps / exp_rate, flops / PEAK_BF16) * 1e3
            row["bound_by"] = "bytes" if bytes_ / PEAK_BYTES >= exps / exp_rate else "operations"
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["vs_library"] = row["ms"] / row["library_ms"]
            row[per] = launches
            emit("time", kernel=name, library=library, **_named(row))
            if launches:
                sums[(path, name)] = sums.get((path, name), 0.0) + launches * row["ms"]
            if stage == 0 and c == BACKBONE["enc_channels"][0] and (path, kern) in (("eval", "fwd"),
                                                                                   ("train", "bwd")):
                results[name] = row
            del got, want
    for (path, name), ms in sums.items():
        emit("attention_sum", path=path, kernel=name, ms_per_forward_or_step=ms,
             note="sum of launches (from the config) x kernel ms over the shapes above (L2-warm, back to back)")
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


def card_vs_cpu(device, cases=None, phase="card_vs_cpu"):
    """Phase 6 (and SpUNet's): small depth, same weights, a small scene: the
    port on the card (kernels) against the port on the CPU (plain
    versions). `cases`: (amp, model config) pairs, PTv3 in f32 and AMP by
    default."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # a 2.4 m room keeps the point density of the 102,400-point scenes
    arrays = scene(100, capacity=16384, extent=2.4)
    valid = arrays["batch"] >= 0
    if cases is None:
        cases = [(amp, dict(MODEL, backbone=_small_ptv3(amp))) for amp in (False, True)]
    for amp, cfg in cases:
        out = {}
        for dev in (device, "cpu"):
            model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
            t0 = time.perf_counter()
            res = model(make_point_batch(arrays, 1, device=dev))
            out[str(dev)] = res["seg_logits"].float().cpu().numpy()[valid]
            out[f"{dev}_s"] = time.perf_counter() - t0
            out[f"{dev}_overflow"] = [int(v) for vs in res["diagnostics"].values() for v in vs]
        gpu, cpu = out[str(device)], out["cpu"]
        rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
        agree = float((gpu.argmax(1) == cpu.argmax(1)).mean())
        max_rel, min_agree = SLICE_BOUNDS[amp]
        emit(phase, amp=amp, points=int(valid.sum()), rel_max_err=rel, bound=max_rel,
             argmax_agreement=agree, agreement_bound=min_agree, cpu_seconds=out["cpu_s"],
             overflow=out["cpu_overflow"])
        if not (rel < max_rel and agree > min_agree):
            raise AssertionError(f"card and CPU disagree ({phase}, amp={amp}): rel {rel}, agreement {agree}")
        if any(out["cpu_overflow"]) or out["cpu_overflow"] != out[f"{device}_overflow"]:
            raise AssertionError(f"{phase}: overflow {out['cpu_overflow']} (CPU), "
                                 f"{out[f'{device}_overflow']} (card)")


def _train_setup(cfg, device, seed, recipe=PTV3_RECIPE):
    import torch

    from pointcept_tpu_torch.engines import build_train_step
    from pointcept_tpu_torch.models import build_model
    from pointcept_tpu_torch.utils import build_optimizer, build_scheduler

    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(seed))
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
    return launches


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


def card_vs_cpu_train(device, cases=None, phase="card_vs_cpu_train"):
    """Phase 8 (and SpUNet's): one train step of the small-depth model on
    the card and on the CPU, same weights, batch and order permutations
    (drawn from a CPU generator of one seed; drop path 0, so nothing else is
    drawn). `cases`: (amp, model config, recipe), PTv3 in f32 and AMP by
    default; the first must be f32.

    The gradients of one step are sensitive by nature: attention operands
    round to bf16 and pooling takes a max, so a change of the input far
    below any rounding moves some gradient tensors by several percent. The
    run measures that noise floor itself: the CPU step again, on features
    scaled by 1 + 1e-6 * N(0, 1). The card must agree with the CPU within
    the slice test's bounds, or within twice the floor where the floor of
    this model and scene is above them."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.engines import make_point_batch

    arrays = scene(100, capacity=16384, extent=2.4, labelled=True)
    nudged = dict(arrays, feat=arrays["feat"] * (1 + 1e-6 * np.random.RandomState(0).randn(
        *arrays["feat"].shape).astype(np.float32)))
    vanishing = set()
    if cases is None:
        cases = [(amp, dict(TRAIN_MODEL, backbone=_small_ptv3(amp, shuffle_orders=True, drop_path=0.0)),
                  PTV3_RECIPE) for amp in (False, True)]
    for amp, cfg, recipe in cases:
        out = {}
        for name, dev, data in (("card", device, arrays), ("cpu", "cpu", arrays),
                                ("cpu_nudged", "cpu", nudged)):
            model, step = _train_setup(cfg, dev, seed=1, recipe=recipe)
            res = step(make_point_batch(data, 1, device=dev), torch.Generator().manual_seed(5))
            out[name] = (float(res["loss"]), {n: p.grad.float().cpu().numpy()
                                              for n, p in model.named_parameters()})
        (gl, gg), (cl, cg), (nl, ng) = out["card"], out["cpu"], out["cpu_nudged"]
        gmax = max(float(np.abs(g).max()) for g in cg.values())
        if not amp:
            # biases that feed only train-mode BatchNorms: zero gradient in
            # exact arithmetic, rounding noise on both devices
            vanishing = {n for n, c in cg.items() if np.abs(c).max() < 1e-6 * gmax}
        worst, worst_name, low_cos = _grad_distance(gg, cg, vanishing, gmax)
        floor, floor_name, floor_cos = _grad_distance(ng, cg, vanishing, gmax)
        max_loss, max_grad, min_cos = TRAIN_BOUNDS[amp]
        max_grad = max(max_grad, 2 * floor)
        min_cos = min(min_cos, 1 - 2 * (1 - floor_cos))
        rel_loss = abs(gl - cl) / abs(cl)
        emit(phase, amp=amp, loss=[gl, cl], rel_loss_err=rel_loss,
             worst_grad_rel_l2=worst, worst_tensor=worst_name, min_cos=low_cos,
             noise_floor=dict(loss=nl, grad_rel_l2=floor, tensor=floor_name, min_cos=floor_cos),
             vanishing_tensors=len(vanishing), bounds=[max_loss, max_grad, min_cos])
        if not (rel_loss < max_loss and worst < max_grad and low_cos > min_cos):
            raise AssertionError(f"card and CPU train steps disagree ({phase}, amp={amp})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pointcept_tpu_torch.ops.kernels import build

    device = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    cap = torch.cuda.get_device_capability(device)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, card=card, capability=list(cap))
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")

    t0 = time.perf_counter()
    logs = build.build_all(["patch_attention", "patch_attention_bwd", "block_fill", "take_back", "tap_conv"])
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    kernels = kernel_cases(device, scene(1000))
    main_path(device, card)
    card_vs_cpu(device)
    launches = train_path(device, card)
    card_vs_cpu_train(device)

    main_path(device, card, SPUNET_MODEL, SPUNET_EVAL_KERNELS, phase="spunet_serving")
    card_vs_cpu(device, [(False, dict(SPUNET_MODEL, backbone=SPUNET_SMALL))], phase="spunet_card_vs_cpu")
    spunet = train_path(device, card, SPUNET_MODEL, SPUNET_RECIPE, SPUNET_TRAIN_KERNELS,
                        phase="spunet_train_path")
    card_vs_cpu_train(device, [(False, dict(SPUNET_MODEL, backbone=SPUNET_SMALL), SPUNET_RECIPE)],
                      phase="spunet_card_vs_cpu_train")
    launches.update({name: spunet[name] for name in ("tap_conv_fwd", "tap_conv_dw")})

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
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in kernels.items()
    ]}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
