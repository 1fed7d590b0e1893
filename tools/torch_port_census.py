#!/usr/bin/env python3
"""How many of the repository's configs the port can run, on the CPU.

    python3 tools/torch_port_census.py [--list]

Parses every config under `configs/` (outside `_base_`) with the port's
`Config` and checks each ``type`` it names against the port's registries
(models, losses, datasets, transforms, hooks, testers, trainers; the
optimizer's and the scheduler's against the ones `build_optimizer` and
`build_scheduler` take). A config whose every type is registered is
"type-complete"; of those, the ones whose model also builds on the meta
device "build". Prints one JSON line of the counts (and, with `--list`, the
configs that build).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OPTIMIZERS = {"AdamW", "SGD"}
SCHEDULERS = {"OneCycleLR", "PolyLR", "CosineAnnealingLR", "MultiStepLR"}


def _types(node, path=""):
    if isinstance(node, dict):
        for key, value in node.items():
            if key == "type" and isinstance(value, str):
                yield path, value
            else:
                yield from _types(value, f"{path}.{key}")
    elif isinstance(node, (list, tuple)):
        for i, value in enumerate(node):
            yield from _types(value, f"{path}.{i}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from pointcept_tpu_torch.datasets import DATASETS, TRANSFORMS
    from pointcept_tpu_torch.engines import TESTERS, TRAINERS
    from pointcept_tpu_torch.engines.hooks.builder import HOOKS
    from pointcept_tpu_torch.models import MODELS, apply_amp_policy
    from pointcept_tpu_torch.models.losses.builder import LOSSES
    from pointcept_tpu_torch.utils.config import Config

    registries = (MODELS, LOSSES, DATASETS, TRANSFORMS, HOOKS, TESTERS, TRAINERS)

    def known(path: str, name: str) -> bool:
        if path.startswith(".optimizer"):
            return name in OPTIMIZERS
        if path.startswith(".scheduler"):
            return name in SCHEDULERS
        return any(r.get(name) is not None for r in registries)

    files = sorted(p for p in (ROOT / "configs").glob("*/*.py") if p.parent.name != "_base_")
    complete, builds, refused = [], [], {}
    for p in files:
        rel = str(p.relative_to(ROOT / "configs"))
        try:
            cfg = Config.fromfile(str(p))
        except Exception:  # a config the port's parser refuses is not type-complete
            continue
        if not all(known(a, n) for a, n in _types(dict(cfg))):
            continue
        complete.append(rel)
        try:
            with torch.device("meta"):
                MODELS.build(apply_amp_policy(dict(cfg.model), cfg.get("enable_amp", False)))
            builds.append(rel)
        except Exception as e:
            refused[rel] = f"{type(e).__name__}: {e}"[:200]
    print(json.dumps({"configs": len(files), "type_complete": len(complete), "build": len(builds),
                      "refused_at_build": refused}))
    if args.list:
        print("\n".join(builds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
