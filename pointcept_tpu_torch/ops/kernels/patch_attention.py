"""Patch attention forward: the CUDA kernel `csrc/patch_attention.cu` and its
plain PyTorch version.

Replaces `_fwd_kernel_kmajor` and `_fwd_kernel`
(pointcept_tpu/ops/pallas/flash_attention.py). A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from . import build


def patch_attention_fwd_plain(qkv_p: torch.Tensor, num_heads: int, scale: float,
                              chunk: int = 8) -> torch.Tensor:
    """qkv_p [nP, K, 3C] -> [nP, K, C] in qkv_p's dtype.

    The kernel's arithmetic: f32 scores of the stored operands, a softmax
    over the whole patch, p rounded to the input dtype before p . v, and the
    f32 denominator of the unrounded p applied last. `chunk` patches at a
    time bound the [chunk, H, K, K] f32 score block."""
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    h = num_heads
    d = c // h
    out = torch.empty((np_, k, c), dtype=qkv_p.dtype, device=qkv_p.device)
    for p0 in range(0, np_, chunk):
        x = qkv_p[p0 : p0 + chunk].reshape(-1, k, 3, h, d)
        q, kk, v = (x[:, :, i].float() for i in range(3))
        s = torch.einsum("pkhd,pmhd->phkm", q, kk) * scale
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("phkm,pmhd->phkd", e.to(qkv_p.dtype).float(), v) / denom
        out[p0 : p0 + chunk] = o.permute(0, 2, 1, 3).reshape(-1, k, c).to(qkv_p.dtype)
    return out


def patch_attention_fwd(qkv_p: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """qkv_p [nP, K, 3C] slot-gathered rows (q | k | v, head-major within
    each) -> [nP, K, C]. On CUDA: bf16, contiguous, head dim 16 or 32, K a
    multiple of 16."""
    if qkv_p.device.type == "cpu":
        return patch_attention_fwd_plain(qkv_p, num_heads, scale)
    if qkv_p.device.type != "cuda":
        raise ValueError(f"patch_attention_fwd: unsupported device {qkv_p.device}")
    if qkv_p.dtype != torch.bfloat16:
        raise TypeError(f"patch_attention_fwd: kernel takes bfloat16, got {qkv_p.dtype}")
    if qkv_p.dim() != 3 or qkv_p.shape[2] % 3 != 0:
        raise ValueError(f"patch_attention_fwd: expected [nP, K, 3C], got {tuple(qkv_p.shape)}")
    if not qkv_p.is_contiguous() or qkv_p.data_ptr() % 16 != 0:
        raise ValueError("patch_attention_fwd: qkv_p must be contiguous and 16-byte aligned")
    if qkv_p.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("patch_attention_fwd: the backward kernel is not ported yet")
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    if c % num_heads != 0 or (c // num_heads) not in (16, 32):
        raise ValueError(f"patch_attention_fwd: head dim {c}/{num_heads} must be 16 or 32")
    d = c // num_heads
    if k % 16 != 0:
        raise ValueError(f"patch_attention_fwd: patch size {k} must be a multiple of 16")
    if (k * (d + 8) + d * (k + 8)) * 2 > 227 * 1024:
        raise ValueError(f"patch_attention_fwd: patch size {k} exceeds shared memory at D={d}")
    out = torch.empty((np_, k, c), dtype=qkv_p.dtype, device=qkv_p.device)
    if np_ == 0:
        return out
    fn = build.cfunc(
        "patch_attention", "patch_attention_fwd",
        [c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_float, c_void_p],
    )
    status = fn(qkv_p.data_ptr(), out.data_ptr(), np_, k, c, num_heads, d, float(scale),
                build.stream_handle(qkv_p.device))
    build.check(status, "patch_attention_fwd")
    patch_attention_fwd.launches += 1
    return out


patch_attention_fwd.launches = 0
