#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pointcept_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (Hopper) and the CUDA toolkit
(`nvcc`); builds the kernels of `pointcept_tpu_torch/csrc/` first. Phases,
each printing JSON lines:

1. device: torch version, the card's name and power limit;
2. build: the CUDA kernels, one nvcc per source, in parallel;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main path (stage-0 tables from a real synthetic scene);
4. times: kernel, plain version, one PyTorch library call computing the same
   function, and the least time the card could take (bound);
5. the main path: the PTv3-base ScanNet eval forward (`DefaultSegmentorV2` +
   `PT-v3m1`, 5 stages at full width, AMP bf16, block-dense convs with 4^3
   blocks) on distinct synthetic scenes of 102,400 points, with the launch
   counters of every kernel set to 0 just before and read just after;
6. the same port on the card and on the CPU (plain versions), small depth,
   same weights: logits compared;
7. one {"kernels": [...]} line.

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
MODEL = dict(type="DefaultSegmentorV2", num_classes=20, backbone_out_channels=64, backbone=BACKBONE,
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
SLICE_BOUNDS = {False: (3e-2, 0.99), True: (5e-2, 0.97)}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def scene(seed: int, capacity: int = CAPACITY, extent: float = 6.0):
    """One collated ScanNet-like synthetic scene at 0.02 m (numpy), labels
    dropped: the repository's benchmark scene (a 6 m room, 4x oversampled,
    center-cropped to `capacity` points)."""
    import numpy as np

    from pointcept_tpu_torch.datasets import synthetic_arrays

    arrays = synthetic_arrays(capacity=capacity, num_scenes=1, seed=seed, num_classes=20,
                              grid_size=0.02, oversample=4.0, extent=extent, crop=True,
                              rng=np.random.RandomState(seed))
    arrays.pop("num_scenes")
    arrays.pop("segment")
    return arrays


def time_ms(fn, samples: int = 7, reps: int = 5) -> float:
    """Median over `samples` of the CUDA-event time of `reps` calls, per call."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


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


def kernel_cases(device, arrays):
    """Phase 3 and 4: every kernel against its plain version, then timed.
    Returns {kernel: dict of the numbers of its main-path case}."""
    import torch
    import torch.nn.functional as F

    from pointcept_tpu_torch.ops.kernels import (
        block_fill, block_fill_plain, patch_attention_fwd, patch_attention_fwd_plain,
        take_back_rows, take_back_rows_plain,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    exp_rate = EXP_PER_CLOCK_PER_SM * sms * clock_hz
    results = {}

    # A. attention: stage 0 (C=32, H=2), stage 2 (C=128, H=8), stage 4 (C=512, H=32)
    pb, t = stage0_tables(arrays, device)
    k = 1024
    for stage, (c, h) in ((0, (32, 2)), (2, (128, 8)), (4, (512, 32))):
        cap = CAPACITY  # the model's static pooled capacity at this stage
        for f in BACKBONE["pool_capacity_factors"][:stage]:
            cap = -(-max(math.ceil(cap * f), 128) // 128) * 128
        np_ = -(-cap // k) + 1  # padded_capacity / K for one scene
        qkv = torch.randn((np_, k, 3 * c), generator=gen, device=device).to(torch.bfloat16)
        d = c // h
        scale = d**-0.5
        got = patch_attention_fwd(qkv, h, scale)
        want = patch_attention_fwd_plain(qkv, h, scale)
        torch.cuda.synchronize()
        # bf16 output rounding (one ulp is 2^-8 relative) plus exp and summation order
        err = check_close(f"patch_attention[C={c}]", got, want, atol=2e-2, rtol=2e-2)
        q, kk, v = (qkv.view(np_, k, 3, h, d)[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        row = dict(
            shape=dict(nP=np_, K=k, C=c, H=h), max_abs_err=err,
            ms=time_ms(lambda: patch_attention_fwd(qkv, h, scale)),
            plain_ms=time_ms(lambda: patch_attention_fwd_plain(qkv, h, scale), samples=3, reps=1),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, kk, v, scale=scale)),
        )
        bytes_ = np_ * k * 4 * c * 2
        exps = np_ * h * k * k
        flops = 4 * np_ * h * k * k * d
        row["bound_ms"] = max(bytes_ / PEAK_BYTES, exps / exp_rate, flops / PEAK_BF16) * 1e3
        row["bound_by"] = "bytes" if bytes_ / PEAK_BYTES >= exps / exp_rate else "operations"
        emit("time", kernel="patch_attention", library="F.scaled_dot_product_attention", **_named(row))
        if stage == 0:
            results["patch_attention"] = row

    # B. block fill at the stem (Cin=6) and stage 0 (Cin=32), tables of the real scene
    b3 = 1 << (3 * BACKBONE["block_bits"])
    rc, starts = t["rc_sorted"], t["fill_start"]
    ok = rc >= 0
    nvalid = int(ok.sum())
    m = starts.shape[0]
    for cin in (6, 32):
        feat = (pb.feat if cin == 6 else torch.randn((pb.capacity, cin), generator=gen, device=device))
        feat = feat.to(torch.bfloat16).contiguous()
        got = block_fill(feat, rc, starts, b3)
        want = block_fill_plain(feat, rc, starts, b3)
        torch.cuda.synchronize()
        err = check_close(f"block_fill[Cin={cin}]", got, want, atol=0.0, rtol=0.0)
        idx, vals = rc[ok].long(), feat[ok]
        row = dict(
            shape=dict(N=pb.capacity, valid=nvalid, m=m, b3=b3, Cin=cin), max_abs_err=err,
            ms=time_ms(lambda: block_fill(feat, rc, starts, b3)),
            plain_ms=time_ms(lambda: block_fill_plain(feat, rc, starts, b3)),
            library_ms=time_ms(lambda: torch.zeros(((m + 1) * b3, cin), dtype=feat.dtype,
                                                   device=device).index_put_((idx,), vals)),
        )
        bytes_ = nvalid * cin * 2 + pb.capacity * 4 + m * 4 + (m + 1) * b3 * cin * 2
        row["bound_ms"] = bytes_ / PEAK_BYTES * 1e3
        row["bound_by"] = "bytes"
        emit("time", kernel="block_fill", library="zeros + index_put_", **_named(row))
        if cin == 32:
            results["block_fill"] = row

    # C. take-back of a stage-0 conv output (Cout=32)
    slot = t["slot"]
    dense = torch.randn(((m + 1) * b3, 32), generator=gen, device=device).to(torch.bfloat16)
    got = take_back_rows(dense, slot)
    want = take_back_rows_plain(dense, slot)
    torch.cuda.synchronize()
    err = check_close("take_back_rows[C=32]", got, want, atol=0.0, rtol=0.0)
    slot_l = slot.long()
    row = dict(
        shape=dict(N=slot.shape[0], R=dense.shape[0], C=32), max_abs_err=err,
        ms=time_ms(lambda: take_back_rows(dense, slot)),
        plain_ms=time_ms(lambda: take_back_rows_plain(dense, slot)),
        library_ms=time_ms(lambda: torch.index_select(dense, 0, slot_l)),
    )
    n = slot.shape[0]
    row["bound_ms"] = (n * 32 * 2 * 2 + n * 4) / PEAK_BYTES * 1e3
    row["bound_by"] = "bytes"
    emit("time", kernel="take_back", library="torch.index_select", **_named(row))
    results["take_back"] = row
    return results


def main_path(device, card):
    """Phase 5: the full-width eval forward, one scene per request."""
    import torch

    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models import build_model
    from pointcept_tpu_torch.ops.kernels import KERNELS

    model = build_model(MODEL, device=device, generator=torch.Generator().manual_seed(0))
    scenes = [scene(seed) for seed in SEEDS]
    points = [int((s["batch"] >= 0).sum()) for s in scenes]
    emit("main_path_setup", capacity=CAPACITY, valid_points=points, requests=REQUESTS)

    def request(arrays):
        res = model(make_point_batch(arrays, 1, device=device))
        logits = res["seg_logits"]
        valid = torch.as_tensor(arrays["batch"] >= 0, device=device)
        overflow = sum(int(v) for vs in res["diagnostics"].values() for v in vs)
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
    emit("main_path", scenes_per_s=REQUESTS / elapsed, request_ms=per_request,
         median_request_ms=statistics.median(per_request),
         peak_memory_bytes=peak, launches=launches,
         launches_per_forward={k: v / REQUESTS for k, v in launches.items()},
         logits_shapes=[c[0] for c in checks], overflow=[c[1] for c in checks],
         finite=[c[2] for c in checks], card=card)
    for shape, overflow, finite in checks:
        if shape != (CAPACITY, MODEL["num_classes"]) or not finite:
            raise AssertionError(f"bad logits: shape {shape}, finite {finite}")
        if overflow != 0:
            raise AssertionError(f"{overflow} points overflowed static capacities")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches


def card_vs_cpu(device):
    """Phase 6: small depth, same weights, a small scene: the port on the card
    (kernels) against the port on the CPU (plain versions)."""
    import numpy as np
    import torch

    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # a 2.4 m room keeps the point density of the 102,400-point scenes
    arrays = scene(100, capacity=16384, extent=2.4)
    valid = arrays["batch"] >= 0
    for amp in (False, True):
        bb = dict(BACKBONE, enc_depths=(1, 1, 1, 1, 1), dec_depths=(1, 1, 1, 1), amp=amp,
                  block_engine_min_points=4096, block_capacity_factor=(1 / 8,) * 5,
                  pool_capacity_factors=(0.5,) * 4)
        cfg = dict(MODEL, backbone=bb)
        out = {}
        for dev in (device, "cpu"):
            model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(1))
            res = model(make_point_batch(arrays, 1, device=dev))
            out[str(dev)] = res["seg_logits"].float().cpu().numpy()[valid]
        gpu, cpu = out[str(device)], out["cpu"]
        rel = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
        agree = float((gpu.argmax(1) == cpu.argmax(1)).mean())
        max_rel, min_agree = SLICE_BOUNDS[amp]
        emit("card_vs_cpu", amp=amp, points=int(valid.sum()), rel_max_err=rel, bound=max_rel,
             argmax_agreement=agree, agreement_bound=min_agree)
        if not (rel < max_rel and agree > min_agree):
            raise AssertionError(f"card and CPU disagree (amp={amp}): rel {rel}, agreement {agree}")


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
    logs = build.build_all(["patch_attention", "block_fill", "take_back"])
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    kernels = kernel_cases(device, scene(1000))
    launches = main_path(device, card)
    card_vs_cpu(device)

    sources = {"patch_attention": "pointcept_tpu_torch/csrc/patch_attention.cu",
               "block_fill": "pointcept_tpu_torch/csrc/block_fill.cu",
               "take_back": "pointcept_tpu_torch/csrc/take_back.cu"}
    replaces = {
        "patch_attention": "pointcept_tpu/ops/pallas/flash_attention.py:206 "
                           "(_fwd_kernel_kmajor; also _fwd_kernel at :51)",
        "block_fill": "pointcept_tpu/ops/pallas/block_fill.py:40",
        "take_back": "pointcept_tpu/ops/pallas/layout_pin.py:30",
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
