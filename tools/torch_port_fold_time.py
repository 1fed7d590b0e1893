#!/usr/bin/env python3
"""The time of the port's key sort on one CUDA card, against the fold it
replaced and against two stable sorts.

    python3 tools/torch_port_fold_time.py [--rows 524288] [--depth 12]

Key triples of two scans of half the rows each, on a grid of ``2**depth``
cells a side (a Waymo step's 524,288 rows at PTv3's depth by default), in
the four orders. Each variant gives the lexicographic order of the triples
where its fold allows, and is timed in turns with the others (CUDA events,
the median of 7 samples of 5 calls):
- ``argsort_keys``: the port's (`ops/serialization.py`, the batch id above
  bit 48, one stable sort of int64);
- ``fold_3d``: the fold the port had before, ``batch << 3*depth | code``
  (one stable sort; wrong once a code passes ``3*depth`` bits);
- ``two_sorts``: a stable sort of the 48-bit codes, then a stable sort of
  the batch ids in that order.
Prints one JSON line a variant and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fold_3d(keys, depth: int):
    """The former fold: ``batch << 3*depth | code`` (padding sentinels
    remapped only where they would not fit)."""
    import torch

    from pointcept_tpu_torch.ops.serialization import BATCH_SENTINEL

    bits = 3 * depth
    bmax = (1 << (63 - bits)) - 1
    b = keys[..., 0].to(torch.int64)
    if bmax - 1 < BATCH_SENTINEL + 1:
        b = torch.where(b >= BATCH_SENTINEL, b - BATCH_SENTINEL + (bmax - 1), b)
    code = (keys[..., 1].to(torch.int64) << 30) | keys[..., 2].to(torch.int64)
    return torch.sort((b << bits) | code, stable=True).indices.to(torch.int32)


def two_sorts(keys, depth: int):
    import torch

    code = (keys[:, 1].to(torch.int64) << 30) | keys[:, 2].to(torch.int64)
    first = torch.sort(code, stable=True).indices
    second = torch.sort(keys[first, 0], stable=True).indices
    return first[second].to(torch.int32)


def time_ms(fn, samples: int = 7, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=524288)
    ap.add_argument("--depth", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_fold_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pointcept_tpu_torch.ops import serialization as ser

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=device).manual_seed(0)
    grid = torch.randint(0, 1 << args.depth, (args.rows, 3), generator=gen, device=device, dtype=torch.int32)
    batch = (torch.arange(args.rows, device=device) >= args.rows // 2).to(torch.int32)
    variants = {"argsort_keys": ser.argsort_keys, "fold_3d": fold_3d, "two_sorts": two_sorts}
    times = {name: [] for name in variants}
    for order in ser.ORDERS:
        keys = ser.encode(grid, batch, args.depth, order)
        want = variants["argsort_keys"](keys, args.depth)
        for name, fn in variants.items():
            got = fn(keys, args.depth)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} orders the in-range keys otherwise ({order})")
        for _ in range(3):  # in turns
            for name, fn in variants.items():
                times[name].append(time_ms(lambda: fn(keys, args.depth)))
    for name, ms in times.items():
        print(json.dumps({"phase": "fold_time", "variant": name, "rows": args.rows, "depth": args.depth,
                          "median_ms": statistics.median(ms), "range_ms": [min(ms), max(ms)], "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
