"""Take-back: the CUDA kernel `csrc/take_back.cu` and its plain PyTorch version.

Replaces `_copy_kernel` (pointcept_tpu/ops/pallas/layout_pin.py), fused with
the row gather it pinned; with a row bound it is also the block fill's VJP
(`_block_fill_bwd`, pointcept_tpu/ops/block_conv.py). A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Optional

import torch

from . import build


def take_back_rows_plain(dense: torch.Tensor, slot: torch.Tensor,
                         bound: Optional[int] = None) -> torch.Tensor:
    """dense [R, C], slot [N] -> contiguous [N, C] with row i = dense[slot[i]],
    or zeros where slot[i] >= `bound` (default R)."""
    if bound is None or bound >= dense.shape[0]:
        return dense[slot.long()]
    ok = slot < bound
    rows = dense[torch.clamp(slot, max=max(bound - 1, 0)).long()]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=dense.dtype, device=dense.device))


def take_back_sizes(n: int, r: int, c: int) -> None:
    """The kernel's int range: rows and elements of its input and output
    (raises past 2^31 - 1)."""
    build.check_int32("take_back_rows", dense_elements=r * c, out_elements=n * c)


def take_back_rows(dense: torch.Tensor, slot: torch.Tensor,
                   bound: Optional[int] = None) -> torch.Tensor:
    """As `take_back_rows_plain`; every slot must be < R. On CUDA: bf16 dense,
    int32 slots, contiguous."""
    if dense.device.type == "cpu":
        return take_back_rows_plain(dense, slot, bound)
    if dense.device.type != "cuda":
        raise ValueError(f"take_back_rows: unsupported device {dense.device}")
    if dense.dtype != torch.bfloat16 or slot.dtype != torch.int32:
        raise TypeError(f"take_back_rows: kernel takes bfloat16 rows and int32 slots, "
                        f"got {dense.dtype} and {slot.dtype}")
    if dense.dim() != 2 or slot.dim() != 1:
        raise ValueError(f"take_back_rows: shapes {tuple(dense.shape)}, {tuple(slot.shape)}")
    if slot.device != dense.device or not dense.is_contiguous() or not slot.is_contiguous():
        raise ValueError("take_back_rows: inputs must be contiguous and on one device")
    if dense.data_ptr() % 16 != 0:
        raise ValueError("take_back_rows: dense must be 16-byte aligned")
    if dense.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("take_back_rows: the raw kernel records no gradient; use TakeBack")
    n = slot.shape[0]
    r, c = dense.shape
    take_back_sizes(n, r, c)
    bound = r if bound is None else min(bound, r)
    out = torch.empty((n, c), dtype=dense.dtype, device=dense.device)
    fn = build.cfunc("take_back", "take_back_rows",
                     [c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_void_p])
    status = fn(dense.data_ptr(), slot.data_ptr(), out.data_ptr(), n, c, bound,
                build.stream_handle(dense.device))
    build.check(status, "take_back_rows")
    take_back_rows.launches += 1
    return out


take_back_rows.launches = 0
