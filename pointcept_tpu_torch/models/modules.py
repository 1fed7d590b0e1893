"""Shared building blocks (counterpart of `pointcept_tpu/models/modules.py`).

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


class _MaskedBatchNormFn(torch.autograd.Function):
    """Train-mode `MaskedBatchNorm` of [R, C] rows as one autograd node that
    keeps only its input for the backward (the composed ops keep four
    [R, C] tensors: at PT-v2's [rows, k, C] neighbourhoods that is most of a
    step's memory). The backward is the gradient in closed form: with
    ``xhat = (x - mean) * rstd`` and ``gy = dy * weight`` summed over every
    row ``j`` (every row's output reads the statistics), a row in the mask
    gets ``rstd * (gy - (sum gy + xhat * sum gy * xhat) / count)`` and a row
    outside it ``rstd * gy``. Returns (y, mean, biased var, count)."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, eps: float):
        xf = x.float()
        mf = mask.float()[:, None]
        cnt = torch.clamp(mf.sum(), min=1.0)
        mean = (xf * mf).sum(dim=0) / cnt
        var = torch.clamp((torch.square(xf - mean) * mf).sum(dim=0) / cnt, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = (x - mean.to(x.dtype)) * rstd.to(x.dtype)
        out = y * weight.to(y.dtype) + bias.to(y.dtype)
        ctx.save_for_backward(x, mask, weight, mean, rstd, cnt)
        ctx.mark_non_differentiable(mean, var, cnt)
        return out, mean, var, cnt

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var, _g_cnt):
        x, mask, weight, mean, rstd, cnt = ctx.saved_tensors
        gf = g.float()
        xhat = (x.float() - mean) * rstd
        gw = (gf * xhat).sum(dim=0)
        gb = gf.sum(dim=0)
        gy = gf * weight.float()
        shift = (gy.sum(dim=0) + xhat * (gy * xhat).sum(dim=0)) / cnt
        gx = rstd * (gy - mask.float()[:, None] * shift)
        return gx.to(x.dtype), None, gw.to(weight.dtype), gb.to(weight.dtype), None


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows only (torch semantics, eps 1e-3,
    momentum 0.01, affine); normalisation in the activation dtype (the bf16
    stream stays bf16).

    Train mode (`_MaskedBatchNormFn`): f32 batch statistics over the rows
    where `mask` holds (every row without one), the variance in two passes
    (shifted), biased for the normalisation and unbiased for the running
    update. Eval: the running statistics."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            if mask is None:
                mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            y, mean, var, cnt = _MaskedBatchNormFn.apply(x, mask, self.weight, self.bias, self.eps)
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
            return y
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


class PDNorm(nn.Module):
    """Prompt-driven normalisation (reference
    `point_prompt_training/prompt_driven_normalization.py:8`; counterpart of
    `PDNorm` in `pointcept_tpu/models/modules.py`): one `MaskedBatchNorm`
    (``norm_type="bn"``, eps 1e-3, momentum 0.01) or `LayerNorm` (``"ln"``)
    a condition (`decouple`) or one shared norm, and with `adaptive`
    ``y * (1 + scale) + shift`` from ``Linear(SiLU(context))`` (``[1,
    context_channels]``, one context a batch).

    Only the batch's condition's norm runs, in train and in eval mode: the
    other conditions' running statistics stay bit for bit (the JAX package
    also runs them in eval mode, as dead code). Names are the reference's:
    ``norm.{i}`` decoupled, ``norm`` shared, ``modulation.1``; SpUNet-v1m3's
    `PDBatchNorm` names them ``bns.{i}`` and ``bn``."""

    decoupled_name = shared_name = "norm"

    def __init__(self, channels: int, conditions, norm_type: str = "bn", decouple: bool = True,
                 adaptive: bool = False, context_channels: int = 256):
        super().__init__()
        if norm_type not in ("bn", "ln"):
            raise ValueError(f"PDNorm: norm_type must be 'bn' or 'ln', got {norm_type!r}")
        self.conditions = tuple(conditions)
        self.norm_type = norm_type
        self.decouple = decouple
        self.adaptive = adaptive

        def make():
            return MaskedBatchNorm(channels) if norm_type == "bn" else LayerNorm(channels)

        if decouple:
            setattr(self, self.decoupled_name, nn.ModuleList([make() for _ in self.conditions]))
        else:
            setattr(self, self.shared_name, make())
        if adaptive:
            self.modulation = nn.Sequential(nn.SiLU(), Linear(context_channels, 2 * channels))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, condition: Optional[str] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.decouple:
            if condition not in self.conditions:
                raise ValueError(f"PDNorm: the batch's condition {condition!r} is not among the model's "
                                 f"conditions {self.conditions}")
            norm = getattr(self, self.decoupled_name)[self.conditions.index(condition)]
        else:
            norm = getattr(self, self.shared_name)
        y = norm(x, mask) if self.norm_type == "bn" else norm(x)
        if self.adaptive:
            if context is None:
                raise ValueError("PDNorm: adaptive normalisation needs the batch's context embedding")
            shift, scale = self.modulation(context).chunk(2, dim=-1)
            y = y * (1.0 + scale) + shift
        return y.to(x.dtype)


class PDBatchNorm(PDNorm):
    """SpUNet-v1m3's PDNorm (reference `spconv_unet_v1m3_pdnorm.py:25`):
    batch norms named ``bns.{i}`` (decoupled) or ``bn``."""

    decoupled_name, shared_name = "bns", "bn"

    def __init__(self, channels: int, conditions, decouple: bool = True, adaptive: bool = False,
                 context_channels: int = 256):
        super().__init__(channels, conditions, "bn", decouple, adaptive, context_channels)


def make_norm(kind: str, channels: int, pd: Optional[dict] = None) -> nn.Module:
    """A ``"bn"`` (`MaskedBatchNorm`) or ``"ln"`` (`LayerNorm`) norm, or its
    `PDNorm` where `pd` (dict of ``bn``, ``ln``, ``conditions``,
    ``decouple``, ``adaptive``) asks for one of that kind."""
    if pd is not None and pd.get(kind):
        return PDNorm(channels, pd["conditions"], kind, pd["decouple"], pd["adaptive"])
    return MaskedBatchNorm(channels) if kind == "bn" else LayerNorm(channels)


def apply_norm(norm: nn.Module, x: torch.Tensor, pb, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`norm` on `x` (a `MaskedBatchNorm` over `mask`'s rows); a `PDNorm`
    also reads the condition and context of the batch `pb`."""
    if isinstance(norm, PDNorm):
        return norm(x, mask, pb.condition, pb.context)
    return norm(x, mask) if isinstance(norm, MaskedBatchNorm) else norm(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu`: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class DropPath(nn.Module):
    """Per-row stochastic depth (timm semantics): in train mode each row is
    kept with probability 1 - rate and scaled by 1 / (1 - rate), the mask
    drawn from the caller's generator; the identity at rate 0 and in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath: train mode draws its mask from an explicit generator")
        keep = 1.0 - self.rate
        rows = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                          device=x.device) < keep
        return torch.where(rows, x / keep, torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


class MLP(nn.Module):
    """fc1 -> GELU -> fc2 (the MLP's dropout is 0 in every config the port
    builds)."""

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
    (and weight norm's direction ``weight_v``) uniform in +-1/sqrt(fan_in),
    biases zero, norms identity, a LoRA adapter's ``lora_a`` N(0, 0.02) and
    its ``lora_b`` zero, a PPT wrapper's trainable ``class_embedding`` N(0,
    0.02) and its context table N(0, 1), an RPE table truncated normal at
    0.02 (flax's `truncated_normal(0.02)`: cut at two deviations, the scale
    raised so that the cut draw keeps 0.02). Parameters are drawn on the CPU
    in module order, so a seed gives the same weights on every device."""
    for m in module.modules():
        t = getattr(m, "rpe_table", None)
        if isinstance(t, nn.Parameter):
            std = 0.02 / 0.87962566103423978
            t.copy_(torch.nn.init.trunc_normal_(torch.empty(t.shape), std=std, a=-2 * std, b=2 * std,
                                                generator=generator))
        a = getattr(m, "lora_a", None)
        if isinstance(a, nn.Parameter):
            a.copy_(torch.randn(a.shape, generator=generator) * 0.02)
            m.lora_b.zero_()
        emb = getattr(m, "class_embedding", None)
        if isinstance(emb, nn.Parameter):
            emb.copy_(torch.randn(emb.shape, generator=generator) * 0.02)
        w = getattr(m, "weight", None)
        v = getattr(m, "weight_v", None)
        if isinstance(v, nn.Parameter):
            bound = v.shape[1] ** -0.5
            v.copy_(torch.rand(v.shape, generator=generator) * (2 * bound) - bound)
        elif isinstance(m, (MaskedBatchNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, nn.Embedding):
            w.copy_(torch.randn(w.shape, generator=generator))
        elif isinstance(w, nn.Parameter) and w.dim() >= 2:
            fan_in = w.shape[1] if isinstance(m, nn.Linear) else w[..., 0].numel()
            bound = fan_in**-0.5
            w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound) - bound)
            b = getattr(m, "bias", None)
            if isinstance(b, nn.Parameter):
                b.zero_()
    return module
