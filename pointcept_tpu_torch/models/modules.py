"""Shared building blocks (counterpart of `pointcept_tpu/models/modules.py`),
eval semantics only.

Dtypes follow the JAX package's AMP policy with explicit casts rather than
`torch.autocast`: a `Linear` with a compute dtype casts its input and its f32
parameters per call (flax `nn.Dense(dtype=bf16)`); without one it computes
in the promoted dtype of input and parameters. Norms keep f32 statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """nn.Linear with the JAX package's dtype policy (see module doc)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d in eval: running statistics, eps 1e-3, affine; computed in
    the activation dtype (the bf16 stream stays bf16)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        y = (x - self.running_mean.to(x.dtype)) * inv.to(x.dtype)
        return y * self.weight.to(y.dtype) + self.bias.to(y.dtype)


class LayerNorm(nn.Module):
    """LayerNorm computed in f32 (eps 1e-5, affine), cast back to the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu`: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """fc1 -> GELU -> fc2 (dropout is the identity in eval)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Linear(in_channels, hidden_channels, compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden_channels, out_channels, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from an explicit generator: every matrix and conv weight
    uniform in +-1/sqrt(fan_in), biases zero, norms identity. Parameters are
    drawn on the CPU in module order, so a seed gives the same weights on
    every device."""
    for m in module.modules():
        w = getattr(m, "weight", None)
        if isinstance(m, (MaskedBatchNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(w, nn.Parameter) and w.dim() >= 2:
            fan_in = w.shape[1] if isinstance(m, nn.Linear) else w[..., 0].numel()
            bound = fan_in**-0.5
            w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound) - bound)
            b = getattr(m, "bias", None)
            if isinstance(b, nn.Parameter):
                b.zero_()
    return module
