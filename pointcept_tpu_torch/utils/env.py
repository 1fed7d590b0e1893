"""Seeding (counterpart of `pointcept_tpu/utils/env.py`; parity target:
reference `pointcept/utils/env.py:17,26`)."""

from __future__ import annotations

import os
import random
from datetime import datetime

import numpy as np


def get_random_seed() -> int:
    return int(datetime.now().strftime("%S%f")) + os.getpid() % 100000


def set_seed(seed=None) -> int:
    """Seed python and numpy (the host-side augmentation). The device's
    randomness comes from `torch.Generator`s that the trainer derives from
    the config's seed and the global step, so no global device state is
    set."""
    if seed is None:
        seed = get_random_seed()
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
