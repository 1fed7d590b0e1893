#!/usr/bin/env python3
"""The serving phase of `chip_smoke.py` alone, from any checkout, on one CUDA card.

    python3 tools/torch_port_serve.py [ROOT]

Builds the kernels of ROOT (default: this checkout) and runs its
`chip_smoke.main_path`: the full-width PTv3-base eval forward on 102,400-point
scenes, one warm-up and 8 timed requests, printing the `main_path` JSON line.
For an A/B of two commits inside one call, unpack the other one into a
directory that `.gitignore` lists and alternate, e.g.

    for r in build/parent . . build/parent; do python3 tools/torch_port_serve.py $r; done
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_serve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pointcept_tpu_torch.ops.kernels import build

    # the serving path's sources (KERNELS names wrappers, not sources)
    build.build_all(["patch_attention", "block_fill", "take_back"])
    print(f"root {root}", flush=True)
    cs.main_path(torch.device("cuda", 0), cs.nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
