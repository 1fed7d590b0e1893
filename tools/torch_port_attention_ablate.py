#!/usr/bin/env python3
"""Where the time goes inside the attention kernels, on one CUDA card.

    python3 tools/torch_port_attention_ablate.py [--out FILE]

Builds variants of `pointcept_tpu_torch/csrc/patch_attention*.cu` that stop
or drop part of the work, each from a copy edited at run time under
build/ablate/ (nothing in the program changes),
and times each beside the full kernel with CUDA events at PTv3-base's
stage-0 shapes (K 1024, D 16): the forward at the eval forward's (nP 101,
C 32, H 2), the backward at the train step's (nP 202) and at stages 2 and 4
(nP 20, C 128, H 8; nP 4, C 512, H 32). The variants give wrong results and
are timed only.

The kernels run unbiased (a null RPE table). Variants: the forward
staging only, staging + pass 1, two blocks an SM
instead of three; the backward without its query
loop (staging, pre-pass and cluster epilogue), with a multiply in place of
each exp, without the dV and dK products, with 32-query steps.

Prints one JSON line per shape, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (variant, source, [(text, replacement), ...]); every text must occur
# exactly once in the source
VARIANTS = [
    ("fwd_staging", "patch_attention.cu", [(
        "  cp_async_wait<1>();\n  __syncthreads();\n  const float c = scale * kLog2e;\n  if (active) {",
        "  cp_async_wait<0>();\n  __syncthreads();\n  if (threadIdx.x == 0)\n"
        "    out[(size_t)blockIdx.x * 8] = *reinterpret_cast<const __nv_bfloat16*>(ks + (blockIdx.x % K) * 2 * D) +\n"
        "                                  *reinterpret_cast<const __nv_bfloat16*>(vs + (blockIdx.x % K) * 2 * D);\n"
        "  return;\n  const float c = scale * kLog2e;\n  if (active) {")]),
    ("fwd_pass1", "patch_attention.cu", [(
        "\n  // pass 2: p = exp",
        "\n  cp_async_wait<0>();\n  if (active && t == 0) out[(p * K + r0 + g) * C + h * D] = __float2bfloat16(m[0][0] + m[0][1]);\n"
        "  return;\n  // pass 2: p = exp")]),
    ("fwd_two_blocks", "patch_attention.cu", [("D == 16 ? (BIAS ? 2 : 3) : 2", "2")]),
    ("bwd_no_loop", "patch_attention_bwd.cu", [("  for (int i = 0; i < nq; ++i) {", "  for (int i = 0; i < 0; ++i) {")]),
    ("bwd_no_exp", "patch_attention_bwd.cu", [
        ("ex2(fmaf(s[n][0], c, -sq[n].x)), p1 = ex2(fmaf(s[n][1], c, -sq[n].z))",
         "(fmaf(s[n][0], c, -sq[n].x)), p1 = (fmaf(s[n][1], c, -sq[n].z))"),
        ("ex2(fmaf(s[n][2], c, -sq[n].x)), p3 = ex2(fmaf(s[n][3], c, -sq[n].z))",
         "(fmaf(s[n][2], c, -sq[n].x)), p3 = (fmaf(s[n][3], c, -sq[n].z))")]),
    ("bwd_no_dkdv", "patch_attention_bwd.cu", [(
        "            mma_bf16(dv[kt][j], pa[kt], dt[j][0], dt[j][1]);\n"
        "            mma_bf16(dk[kt][j], da[kt], qt[j][0], qt[j][1]);\n", "")]),
    ("bwd_step32", "patch_attention_bwd.cu", [("constexpr int kStep = 64;", "constexpr int kStep = 32;")]),
]
FWD_SHAPE = (101, 32, 2)
BWD_SHAPES = ((202, 32, 2), (20, 128, 8), (4, 512, 32))


def build_variants(csrc: str, recipes, out_dir: str) -> dict:
    """Writes and compiles each variant (and the unedited sources as
    `fwd_full`, `bwd_full`); returns {variant: library path}."""
    from pointcept_tpu_torch.ops.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    for h in os.listdir(csrc):
        if h.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, h), out_dir)
    jobs = [("fwd_full", "patch_attention.cu", []), ("bwd_full", "patch_attention_bwd.cu", [])] + recipes
    procs = {}
    for name, source, edits in jobs:
        with open(os.path.join(csrc, source)) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to edit occurs {text.count(old)} times in {source}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = lib
    return libs


def time_ms(fn, samples: int = 7, reps: int = 5) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_attention_ablate: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import nvidia_smi
    from pointcept_tpu_torch.ops.kernels.patch_attention import bwd_plan

    csrc = os.path.join(ROOT, "pointcept_tpu_torch", "csrc")
    libs = build_variants(csrc, VARIANTS, os.path.join(ROOT, "build", "ablate"))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the entry points' arguments; a null RPE table runs the unbiased kernels
    fwd_args = [vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, vp, vp, ci, vp]
    lines = []

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        lines.append(line)

    card = nvidia_smi("name,power.limit")
    k = 1024
    np_, c, h = FWD_SHAPE
    d, scale = c // h, (c // h) ** -0.5
    qkv = torch.randn((np_, k, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((np_, k, c), dtype=torch.bfloat16, device=dev)
    row = dict(kernel="patch_attention_fwd", card=card, nP=np_, K=k, C=c, H=h)
    for name, lib in libs.items():
        if name.startswith("fwd"):
            fn = ctypes.CDLL(lib).patch_attention_fwd
            fn.argtypes = fwd_args
            row[f"{name}_ms"] = time_ms(lambda: fn(qkv.data_ptr(), out.data_ptr(), None, None, np_, k, c, h, d,
                                                  scale, None, None, 0, stream))
    emit(row)

    fwd = ctypes.CDLL(libs["fwd_full"]).patch_attention_fwd
    fwd.argtypes = fwd_args
    for np_, c, h in BWD_SHAPES:
        d, scale = c // h, (c // h) ** -0.5
        qkv = torch.randn((np_, k, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
        dout = torch.randn((np_, k, c), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((np_, k, c), dtype=torch.bfloat16, device=dev)
        m = torch.empty((np_, h, k), device=dev)
        l = torch.empty_like(m)
        fwd(qkv.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), np_, k, c, h, d, scale, None, None, 0,
            stream)
        dqkv = torch.empty_like(qkv)
        stats = torch.empty((np_, h, k, 2), device=dev)
        split, warps, tiles, _ = bwd_plan(k, d)
        row = dict(kernel="patch_attention_bwd", card=card, nP=np_, K=k, C=c, H=h)
        for name, lib in libs.items():
            if not name.startswith("bwd"):
                continue
            fn = ctypes.CDLL(lib).patch_attention_bwd
            fn.argtypes = [vp] * 7 + [ci] * 8 + [cf, vp, vp, ci, vp, vp]
            row[f"{name}_ms"] = time_ms(lambda: fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), m.data_ptr(),
                                                   l.data_ptr(), stats.data_ptr(), dqkv.data_ptr(), np_, k, c, h, d,
                                                   split, warps, tiles, scale, None, None, 0, None, stream))
        emit(row)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
