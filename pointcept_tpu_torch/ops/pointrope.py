"""3D rotary position embedding (counterpart of `pointcept_tpu/ops/pointrope.py`;
reference: the CUDA `libs/pointrope` extension and its torch fallback).

The head dim is split into three equal parts; part i is rotated by classic
RoPE at the points' coordinate i (a float position, as the JAX package
casts it). Elementwise torch: the JAX package computes it outside any
Pallas kernel, and the backward is autograd's.
"""

from __future__ import annotations

import torch


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rope1d(tokens: torch.Tensor, pos: torch.Tensor, base: float, f0: float) -> torch.Tensor:
    """tokens [..., K, D], pos [..., K]: cos and sin in f32, rounded to the
    tokens' dtype before they multiply (as the JAX package)."""
    d = tokens.shape[-1]
    inv_freq = f0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32, device=tokens.device) / d))
    freqs = pos[..., None].float() * inv_freq
    freqs = torch.cat([freqs, freqs], dim=-1)
    return tokens * freqs.cos().to(tokens.dtype) + _rotate_half(tokens) * freqs.sin().to(tokens.dtype)


def point_rope(tokens: torch.Tensor, positions: torch.Tensor, freq: float = 100.0,
               f0: float = 1.0) -> torch.Tensor:
    """tokens [..., H, K, D] (D a multiple of 6: three parts of rotation
    pairs), positions [..., K, 3] (broadcast over the heads) -> the rotated
    tokens."""
    d = tokens.shape[-1]
    if d % 6 != 0:
        raise ValueError(f"point_rope: head dim {d} must be a multiple of 6 (three parts of rotation pairs)")
    parts = tokens.split(d // 3, dim=-1)
    return torch.cat([_rope1d(parts[i], positions[..., None, :, i], freq, f0) for i in range(3)], dim=-1)
