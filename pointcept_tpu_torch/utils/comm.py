"""Process identity over `torch.distributed` (counterpart of
`pointcept_tpu/utils/comm.py`). The port trains in one process on one card:
`get_world_size` / `get_rank` read an initialised process group, else 1 /
0."""

from __future__ import annotations

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0
