"""Block fill: the CUDA kernel `csrc/block_fill.cu` and its plain PyTorch version.

Replaces `_fill_kernel` (pointcept_tpu/ops/pallas/block_fill.py), in both of
its uses: the forward fill of a block conv, and the take-back's VJP
(`_take_back_bwd`, pointcept_tpu/ops/block_conv.py). A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from . import build


def block_fill_plain(feat_sorted: torch.Tensor, rc_sorted: torch.Tensor, starts: torch.Tensor,
                     b3: int) -> torch.Tensor:
    """feat_sorted [N, C], rc_sorted [N] int32 (rank*b3 + raster_local, -1 =
    none), starts [m] -> dense [(m+1)*b3, C]: each point at row rc, zeros
    elsewhere, tile m all zero."""
    m = starts.shape[0]
    out = torch.zeros(((m + 1) * b3, feat_sorted.shape[1]), dtype=feat_sorted.dtype,
                      device=feat_sorted.device)
    ok = rc_sorted >= 0
    out[rc_sorted[ok].long()] = feat_sorted[ok]
    return out


def fill_sizes(n: int, c: int, m: int, b3: int) -> None:
    """The kernel's int range: rows, codes and elements of its input and
    output (raises past 2^31 - 1)."""
    build.check_int32("block_fill", feat_elements=n * c, codes=(m + 1) * b3, out_elements=(m + 1) * b3 * c)


def block_fill(feat_sorted: torch.Tensor, rc_sorted: torch.Tensor, starts: torch.Tensor,
               b3: int) -> torch.Tensor:
    """As `block_fill_plain`; block t's members must sit at sorted rows
    [starts[t], starts[t] + b3). On CUDA: bf16 feat, int32 codes, contiguous."""
    if feat_sorted.device.type == "cpu":
        return block_fill_plain(feat_sorted, rc_sorted, starts, b3)
    if feat_sorted.device.type != "cuda":
        raise ValueError(f"block_fill: unsupported device {feat_sorted.device}")
    if feat_sorted.dtype != torch.bfloat16:
        raise TypeError(f"block_fill: kernel takes bfloat16, got {feat_sorted.dtype}")
    if rc_sorted.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("block_fill: rc_sorted and starts must be int32")
    if feat_sorted.dim() != 2 or rc_sorted.shape != (feat_sorted.shape[0],) or starts.dim() != 1:
        raise ValueError(
            f"block_fill: shapes {tuple(feat_sorted.shape)}, {tuple(rc_sorted.shape)}, "
            f"{tuple(starts.shape)}"
        )
    for t in (feat_sorted, rc_sorted, starts):
        if t.device != feat_sorted.device or not t.is_contiguous():
            raise ValueError("block_fill: inputs must be contiguous and on one device")
    if feat_sorted.data_ptr() % 16 != 0:
        raise ValueError("block_fill: feat_sorted must be 16-byte aligned")
    if feat_sorted.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("block_fill: the raw kernel records no gradient; use BlockFill")
    n, c = feat_sorted.shape
    m = starts.shape[0]
    fill_sizes(n, c, m, b3)
    out = torch.empty(((m + 1) * b3, c), dtype=feat_sorted.dtype, device=feat_sorted.device)
    fn = build.cfunc(
        "block_fill", "block_fill",
        [c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_void_p],
    )
    status = fn(feat_sorted.data_ptr(), rc_sorted.data_ptr(), starts.data_ptr(), out.data_ptr(),
                n, m, b3, c, build.stream_handle(feat_sorted.device))
    build.check(status, "block_fill")
    block_fill.launches += 1
    return out


block_fill.launches = 0
