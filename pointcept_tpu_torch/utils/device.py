"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller names another device. With no
device named and no GPU present they raise: the port never carries on quietly
on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
