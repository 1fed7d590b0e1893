"""Fused block conv: the CUDA kernels `csrc/tap_conv.cu` (`tap_conv_fwd`,
`tap_conv_dw`) and their plain PyTorch versions.

Replace `_conv_kernel_banded` / `_conv_kernel_sliced` (via `tap_conv`) and
`_dw_kernel_banded` / `_dw_kernel_sliced` (via `tap_conv_dw`) of
pointcept_tpu/ops/pallas/tap_conv.py, with the halo assembly that feeds them
(`_fused_conv`, pointcept_tpu/ops/block_conv.py) folded into the kernels: the
kernels read the halo straight from the neighbour tiles through ``nbr_ext``.

Both compute only the occupied tiles (``r < m`` and ``nbr_ext[r, 13] == r``):
the forward writes zeros for every other tile, the weight gradient sums over
the occupied ones. Inputs from the block fill hold zeros there, so this is
the JAX package's function on such inputs. A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import itertools
import math
from ctypes import c_int, c_void_p

import torch

from . import build

CENTER = 13  # the self column of the 27-neighbour table (OFFS27 order)
MAX_CHANNELS = 512
_SMS = 132  # streaming multiprocessors of an H100: the weight gradient's partials fill two waves
MAX_PARTIALS = 64
DW_NT, DW_TAPS = 32, 32  # the weight gradient's output channels and taps a block


def occupied_tiles(nbr_ext: torch.Tensor) -> torch.Tensor:
    """[m+1] bool: tile r is occupied (r < m and its self column is r)."""
    r = nbr_ext.shape[0]
    idx = torch.arange(r, dtype=nbr_ext.dtype, device=nbr_ext.device)
    return (nbr_ext[:, CENTER] == idx) & (idx < r - 1)


def _taps(b: int, k: int):
    """(tap index, halo slice) of each tap in `kernel_offsets` order."""
    for t, (dx, dy, dz) in enumerate(itertools.product(range(k), repeat=3)):
        yield t, (slice(None), slice(dx, dx + b), slice(dy, dy + b), slice(dz, dz + b))


def _halo(dense: torch.Tensor, nbr_ext: torch.Tensor, b: int, k: int) -> torch.Tensor:
    from ..block_conv import _halo_expand

    r = nbr_ext.shape[0]
    return _halo_expand(dense.view(r, b, b, b, dense.shape[1]), nbr_ext, (k - 1) // 2)


def tap_conv_fwd_plain(dense: torch.Tensor, nbr_ext: torch.Tensor, weight: torch.Tensor,
                       b: int, k: int) -> torch.Tensor:
    """dense [(m+1)*b^3, Cin], nbr_ext [m+1, 27], weight [k^3, Cin, Cout] ->
    [(m+1)*b^3, Cout] in dense's dtype: the halo expansion, then per tap an
    f32 matmul of the operands rounded to dense's dtype, summed in f32; zero
    at the tiles that are not occupied."""
    r = nbr_ext.shape[0]
    b3 = b**3
    hal = _halo(dense, nbr_ext, b, k)
    w = weight.to(dense.dtype).float()
    out = torch.zeros((r * b3, weight.shape[2]), dtype=torch.float32, device=dense.device)
    for t, sl in _taps(b, k):
        out += hal[sl].reshape(r * b3, -1).float() @ w[t]
    keep = occupied_tiles(nbr_ext).repeat_interleave(b3)[:, None]
    return torch.where(keep, out, 0.0).to(dense.dtype)


def tap_conv_dw_plain(dense: torch.Tensor, nbr_ext: torch.Tensor, g: torch.Tensor,
                      b: int, k: int) -> torch.Tensor:
    """The weight gradient of `tap_conv_fwd_plain`: per tap the transposed
    halo slice times the cotangent g [(m+1)*b^3, Cout] of the occupied tiles,
    f32 [k^3, Cin, Cout]."""
    r = nbr_ext.shape[0]
    b3 = b**3
    hal = _halo(dense, nbr_ext, b, k)
    keep = occupied_tiles(nbr_ext).repeat_interleave(b3)[:, None]
    gm = torch.where(keep, g.float(), 0.0)
    return torch.stack([hal[sl].reshape(r * b3, -1).float().T @ gm for _, sl in _taps(b, k)])


def _check(dense: torch.Tensor, nbr_ext: torch.Tensor, b: int, k: int, what: str) -> int:
    """Validates the kernel inputs shared by both wrappers; returns m."""
    if dense.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dense.device}")
    if dense.dtype != torch.bfloat16 or nbr_ext.dtype != torch.int32:
        raise TypeError(f"{what}: kernel takes bfloat16 tiles and an int32 table, "
                        f"got {dense.dtype} and {nbr_ext.dtype}")
    if b not in (4, 8) or k not in (3, 5):
        raise ValueError(f"{what}: block size {b} and kernel size {k} not in (4, 8) x (3, 5)")
    if nbr_ext.dim() != 2 or nbr_ext.shape[1] != 27 or dense.dim() != 2:
        raise ValueError(f"{what}: shapes {tuple(dense.shape)}, {tuple(nbr_ext.shape)}")
    if dense.shape[0] != nbr_ext.shape[0] * b**3:
        raise ValueError(f"{what}: {dense.shape[0]} rows for {nbr_ext.shape[0]} tiles of {b**3}")
    if not 1 <= dense.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"{what}: {dense.shape[1]} input channels, not in [1, {MAX_CHANNELS}]")
    for t in (dense, nbr_ext):
        if t.device != dense.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous and on one device")
    if dense.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: dense must be 16-byte aligned")
    if dense.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: the raw kernel records no gradient; use FusedBlockConv")
    return nbr_ext.shape[0] - 1


def _tiling(cin: int, cout: int, nt: int = 0):
    """(ck, cin_p, nt, cout_p): the input-channel chunk and output-channel
    tile of the kernels, and the widths padded to them. The forward takes
    64 output channels a block where they divide Cout; the weight gradient
    always 32 (`nt`), as its warps hold four taps' sums each."""
    ck = 16 if cin <= 16 else 32
    nt = nt or (64 if cout % 64 == 0 else 32)
    return ck, -(-cin // ck) * ck, nt, -(-cout // nt) * nt


def tap_conv_fwd(dense: torch.Tensor, nbr_ext: torch.Tensor, weight: torch.Tensor,
                 b: int, k: int) -> torch.Tensor:
    """As `tap_conv_fwd_plain`. On CUDA: bf16 tiles, an int32 table, b in
    (4, 8), k in (3, 5), up to 512 channels each way; the weight is rounded
    to bf16."""
    if dense.device.type == "cpu":
        return tap_conv_fwd_plain(dense, nbr_ext, weight, b, k)
    m = _check(dense, nbr_ext, b, k, "tap_conv_fwd")
    cin = dense.shape[1]
    if weight.dim() != 3 or weight.shape[:2] != (k**3, cin) or weight.device != dense.device:
        raise ValueError(f"tap_conv_fwd: weight {tuple(weight.shape)} for k {k}, Cin {cin}")
    cout = weight.shape[2]
    if not 1 <= cout <= MAX_CHANNELS:
        raise ValueError(f"tap_conv_fwd: {cout} output channels, not in [1, {MAX_CHANNELS}]")
    ck, cin_p, nt, cout_p = _tiling(cin, cout)
    wt = torch.zeros((k**3, cout_p, cin_p), dtype=torch.bfloat16, device=dense.device)
    wt[:, :cout, :cin] = weight.detach().transpose(1, 2)
    out = torch.empty((dense.shape[0], cout), dtype=torch.bfloat16, device=dense.device)
    fn = build.cfunc("tap_conv", "tap_conv_fwd", [c_void_p] * 4 + [c_int] * 9 + [c_void_p])
    status = fn(dense.data_ptr(), nbr_ext.data_ptr(), wt.data_ptr(), out.data_ptr(), m, b, k, cin,
                cin_p, cout, cout_p, nt, ck, build.stream_handle(dense.device))
    build.check(status, "tap_conv_fwd")
    tap_conv_fwd.launches += 1
    return out


tap_conv_fwd.launches = 0


def dw_partials(k: int, cin: int, cout: int, m: int) -> int:
    """The fixed number of f32 partials the weight gradient splits the
    occupied tiles into: enough blocks for two waves of the card's SMs."""
    ck, cin_p, nt, cout_p = _tiling(cin, cout, DW_NT)
    blocks = -(-(k**3) // DW_TAPS) * (cin_p // ck) * (cout_p // nt)
    return max(1, min(MAX_PARTIALS, math.ceil(2 * _SMS / blocks), max(m, 1)))


def tap_conv_dw(dense: torch.Tensor, nbr_ext: torch.Tensor, g: torch.Tensor,
                b: int, k: int) -> torch.Tensor:
    """As `tap_conv_dw_plain`: f32 [k^3, Cin, Cout], bit-reproducible (fixed
    partials added in order, no atomics). On CUDA: bf16 tiles and cotangent."""
    if dense.device.type == "cpu":
        return tap_conv_dw_plain(dense, nbr_ext, g, b, k)
    m = _check(dense, nbr_ext, b, k, "tap_conv_dw")
    if g.dtype != torch.bfloat16 or g.dim() != 2 or g.shape[0] != dense.shape[0]:
        raise ValueError(f"tap_conv_dw: cotangent {g.dtype} {tuple(g.shape)} for tiles "
                         f"{tuple(dense.shape)}")
    if g.device != dense.device or not g.is_contiguous() or g.data_ptr() % 16 != 0:
        raise ValueError("tap_conv_dw: the cotangent must be contiguous, 16-byte aligned and on "
                         "the tiles' device")
    cin, cout = dense.shape[1], g.shape[1]
    if not 1 <= cout <= MAX_CHANNELS:
        raise ValueError(f"tap_conv_dw: {cout} output channels, not in [1, {MAX_CHANNELS}]")
    ck, cin_p, nt, cout_p = _tiling(cin, cout, DW_NT)
    parts = dw_partials(k, cin, cout, m)
    dev = dense.device
    lst = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    partial = torch.empty((parts, k**3, cin_p, cout_p), dtype=torch.float32, device=dev)
    dw = torch.empty((k**3, cin, cout), dtype=torch.float32, device=dev)
    fn = build.cfunc("tap_conv", "tap_conv_dw", [c_void_p] * 7 + [c_int] * 10 + [c_void_p])
    status = fn(dense.data_ptr(), nbr_ext.data_ptr(), g.data_ptr(), lst.data_ptr(), cnt.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), m, b, k, cin, cin_p, cout, cout_p, nt, ck, parts,
                build.stream_handle(dev))
    build.check(status, "tap_conv_dw")
    tap_conv_dw.launches += 1
    return dw


tap_conv_dw.launches = 0
