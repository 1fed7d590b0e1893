"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

| wrapper | source | replaces (TPU kernel) |
|---|---|---|
| `patch_attention_fwd` | csrc/patch_attention.cu | `_fwd_kernel_kmajor`, `_fwd_kernel` (ops/pallas/flash_attention.py) |
| `patch_attention_bwd` | csrc/patch_attention_bwd.cu | `_bwd_kernel_kmajor`, `_bwd_kernel_kmajor_chunked`, `_bwd_kernel`, `_bwd_kernel_chunked` (same file) |
| `patch_attention_rpe_fwd`, `patch_attention_rpe_bwd` | csrc/patch_attention_rpe.cu, csrc/patch_attention_bwd_rpe.cu: the two sources' instances with the RPE score bias (and the table's gradient) | the same kernels; the TPU kernels take no bias |
| `block_fill` | csrc/block_fill.cu | `_fill_kernel` (ops/pallas/block_fill.py), also as the take-back's VJP |
| `take_back_rows` | csrc/take_back.cu | `_copy_kernel` (ops/pallas/layout_pin.py), fused with its gather; also the fill's VJP |
| `tap_conv_fwd` | csrc/tap_conv.cu | `_conv_kernel_banded`, `_conv_kernel_sliced` (ops/pallas/tap_conv.py) with the halo assembly; also the input gradient |
| `tap_conv_dw` | csrc/tap_conv.cu | `_dw_kernel_banded`, `_dw_kernel_sliced` (same file) |

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from .block_fill import block_fill, block_fill_plain
from .patch_attention import (
    PatchAttention, patch_attention_bwd, patch_attention_bwd_plain, patch_attention_fwd,
    patch_attention_fwd_plain, patch_attention_rpe_bwd, patch_attention_rpe_fwd,
)
from .take_back import take_back_rows, take_back_rows_plain
from .tap_conv import tap_conv_dw, tap_conv_dw_plain, tap_conv_fwd, tap_conv_fwd_plain

KERNELS = {
    "patch_attention": patch_attention_fwd,
    "patch_attention_bwd": patch_attention_bwd,
    "patch_attention_rpe": patch_attention_rpe_fwd,
    "patch_attention_rpe_bwd": patch_attention_rpe_bwd,
    "block_fill": block_fill,
    "take_back": take_back_rows,
    "tap_conv_fwd": tap_conv_fwd,
    "tap_conv_dw": tap_conv_dw,
}

__all__ = [
    "KERNELS",
    "PatchAttention",
    "block_fill",
    "block_fill_plain",
    "patch_attention_bwd",
    "patch_attention_bwd_plain",
    "patch_attention_fwd",
    "patch_attention_fwd_plain",
    "patch_attention_rpe_bwd",
    "patch_attention_rpe_fwd",
    "take_back_rows",
    "take_back_rows_plain",
    "tap_conv_dw",
    "tap_conv_dw_plain",
    "tap_conv_fwd",
    "tap_conv_fwd_plain",
]
