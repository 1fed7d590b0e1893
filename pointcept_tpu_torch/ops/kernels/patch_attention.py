"""Patch attention: the CUDA kernels `csrc/patch_attention.cu` (forward) and
`csrc/patch_attention_bwd.cu` (backward), their plain PyTorch versions, and the
`PatchAttention` autograd function that joins them.

Replaces `_fwd_kernel_kmajor`, `_fwd_kernel`, and the backward kernels
`_bwd_kernel_kmajor`, `_bwd_kernel_kmajor_chunked`, `_bwd_kernel`,
`_bwd_kernel_chunked` (pointcept_tpu/ops/pallas/flash_attention.py). A tensor
on the CPU takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from . import build

SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper (227 KB)
_BWD_STEP = 64  # queries a warp of the backward handles in one step
_BWD_MAX_CLUSTER = 8  # the portable cluster size


def patch_attention_fwd_plain(qkv_p: torch.Tensor, num_heads: int, scale: float,
                              chunk: int = 8, stats: bool = False):
    """qkv_p [nP, K, 3C] -> [nP, K, C] in qkv_p's dtype; with `stats` also
    the f32 row max m and denominator l, [nP, H, K] each.

    The kernel's arithmetic: f32 scores of the stored operands, a softmax
    over the whole patch, p rounded to the input dtype before p . v, and the
    f32 denominator of the unrounded p applied last. `chunk` patches at a
    time bound the [chunk, H, K, K] f32 score block."""
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    h = num_heads
    d = c // h
    out = torch.empty((np_, k, c), dtype=qkv_p.dtype, device=qkv_p.device)
    m_all = torch.empty((np_, h, k), dtype=torch.float32, device=qkv_p.device)
    l_all = torch.empty_like(m_all)
    for p0 in range(0, np_, chunk):
        x = qkv_p[p0 : p0 + chunk].reshape(-1, k, 3, h, d)
        q, kk, v = (x[:, :, i].float() for i in range(3))
        s = torch.einsum("pkhd,pmhd->phkm", q, kk) * scale
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        denom = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("phkm,pmhd->phkd", e.to(qkv_p.dtype).float(), v) / denom
        out[p0 : p0 + chunk] = o.permute(0, 2, 1, 3).reshape(-1, k, c).to(qkv_p.dtype)
        m_all[p0 : p0 + chunk] = m[..., 0]
        l_all[p0 : p0 + chunk] = denom[..., 0]
    return (out, m_all, l_all) if stats else out


def _check(qkv_p: torch.Tensor, num_heads: int, what: str) -> int:
    """Validates a kernel's packed qkv input; returns the head dim."""
    if qkv_p.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qkv_p.device}")
    if qkv_p.dtype != torch.bfloat16:
        raise TypeError(f"{what}: kernel takes bfloat16, got {qkv_p.dtype}")
    if qkv_p.dim() != 3 or qkv_p.shape[2] % 3 != 0:
        raise ValueError(f"{what}: expected [nP, K, 3C], got {tuple(qkv_p.shape)}")
    if not qkv_p.is_contiguous() or qkv_p.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: qkv_p must be contiguous and 16-byte aligned")
    if qkv_p.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: the raw kernel records no gradient; use PatchAttention")
    c = qkv_p.shape[2] // 3
    if c % num_heads != 0 or (c // num_heads) not in (16, 32):
        raise ValueError(f"{what}: head dim {c}/{num_heads} must be 16 or 32")
    if qkv_p.shape[1] % 16 != 0:
        raise ValueError(f"{what}: patch size {qkv_p.shape[1]} must be a multiple of 16")
    return c // num_heads


def patch_attention_fwd(qkv_p: torch.Tensor, num_heads: int, scale: float, stats: bool = False):
    """qkv_p [nP, K, 3C] slot-gathered rows (q | k | v, head-major within
    each) -> [nP, K, C]; with `stats` also the row statistics m, l that
    `patch_attention_bwd` takes. On CUDA: bf16, contiguous, head dim 16 or
    32, K a multiple of 16."""
    if qkv_p.device.type == "cpu":
        return patch_attention_fwd_plain(qkv_p, num_heads, scale, stats=stats)
    d = _check(qkv_p, num_heads, "patch_attention_fwd")
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    if fwd_shared_memory(k, d) > SMEM_LIMIT:
        raise ValueError(f"patch_attention_fwd: patch size {k} exceeds shared memory at D={d}")
    out = torch.empty((np_, k, c), dtype=qkv_p.dtype, device=qkv_p.device)
    m = l = None
    if stats:
        m = torch.empty((np_, num_heads, k), dtype=torch.float32, device=qkv_p.device)
        l = torch.empty_like(m)
    if np_ > 0:
        fn = build.cfunc(
            "patch_attention", "patch_attention_fwd",
            [c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_float,
             c_void_p],
        )
        status = fn(qkv_p.data_ptr(), out.data_ptr(), 0 if m is None else m.data_ptr(),
                    0 if l is None else l.data_ptr(), np_, k, c, num_heads, d, float(scale),
                    build.stream_handle(qkv_p.device))
        build.check(status, "patch_attention_fwd")
        patch_attention_fwd.launches += 1
    return (out, m, l) if stats else out


patch_attention_fwd.launches = 0


def patch_attention_bwd_plain(qkv_p: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                              m: torch.Tensor, l: torch.Tensor, num_heads: int, scale: float,
                              chunk: int = 8) -> torch.Tensor:
    """The backward kernel's arithmetic step by step -> dqkv [nP, K, 3C] in
    qkv_p's dtype.

    p = exp(s - m) * (1 / l) in f32 (the forward's unrounded p), the row term
    rowsum(dO o O) from the forward's stored output, dS = p (dP - row) scale;
    p and dS are rounded to qkv_p's dtype as operands of dV = p^T dO,
    dQ = dS K and dK = dS^T Q, every product accumulates in f32."""
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    h = num_heads
    d = c // h
    dt = qkv_p.dtype
    dqkv = torch.empty_like(qkv_p)
    for p0 in range(0, np_, chunk):
        x = qkv_p[p0 : p0 + chunk].reshape(-1, k, 3, h, d)
        q, kk, v = (x[:, :, i].float() for i in range(3))
        do = dout[p0 : p0 + chunk].reshape(-1, k, h, d).float()
        o = out[p0 : p0 + chunk].reshape(-1, k, h, d).float()
        row = (do * o).sum(dim=-1).permute(0, 2, 1)[..., None]  # [p, h, k, 1]
        s = torch.einsum("pkhd,pmhd->phkm", q, kk) * scale
        p = torch.exp(s - m[p0 : p0 + chunk, ..., None]) * (1.0 / l[p0 : p0 + chunk, ..., None])
        dp = torch.einsum("pkhd,pmhd->phkm", do, v)
        ds = (p * (dp - row) * scale).to(dt).float()
        dq = torch.einsum("phkm,pmhd->pkhd", ds, kk)
        dk = torch.einsum("phkm,pkhd->pmhd", ds, q)
        dv = torch.einsum("phkm,pkhd->pmhd", p.to(dt).float(), do)
        dqkv[p0 : p0 + chunk] = torch.stack([dq, dk, dv], dim=2).reshape(-1, k, c3).to(dt)
    return dqkv


def fwd_shared_memory(k: int, d: int) -> int:
    """Bytes of shared memory a forward block takes: K and V of one
    (patch, head), bf16, unpadded."""
    return 2 * k * d * 2


def bwd_plan(k: int, d: int):
    """(S, W, T, shared memory bytes) of the backward kernel at patch size k
    and head dim d: S blocks (one cluster) split the k keys of a (patch,
    head), W warps a block own T key tiles of 16 each: four at D = 16 where
    k is a multiple of 64 (each Q and dO fragment read from shared memory,
    and each dQ update, then serves 64 keys; at most 8 warps, for the
    registers), else one. A block holds Q and dO of the whole patch (bf16),
    each query's lse2 and row term (an f32 pair) and an f32 dQ tile, over k
    rounded up to whole 64-query tiles. W is at most 16 (D = 16) or 8
    (D = 32: more registers a warp) and at most the number of query tiles,
    since warp w handles tile (i + w) mod tiles at its i-th step."""
    kp = -(-k // _BWD_STEP) * _BWD_STEP
    t = 4 if d == 16 and k % 64 == 0 else 1
    tiles = k // (16 * t)
    w = min(8 if t == 4 or d == 32 else 16, kp // _BWD_STEP)
    s = -(-tiles // w)
    w = -(-tiles // s)
    return s, w, t, kp * (2 * d * 2 + 8 + d * 4)


def patch_attention_bwd(qkv_p: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                        m: torch.Tensor, l: torch.Tensor, num_heads: int,
                        scale: float) -> torch.Tensor:
    """As `patch_attention_bwd_plain`: qkv_p [nP, K, 3C], the forward's output
    `out` and its cotangent `dout` [nP, K, C], its row statistics m, l
    [nP, H, K] -> dqkv [nP, K, 3C]. On CUDA: bf16 rows, f32 statistics, all
    contiguous."""
    if qkv_p.device.type == "cpu":
        return patch_attention_bwd_plain(qkv_p, out, dout, m, l, num_heads, scale)
    d = _check(qkv_p, num_heads, "patch_attention_bwd")
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    for name, t, shape, dtype in (("out", out, (np_, k, c), torch.bfloat16),
                                  ("dout", dout, (np_, k, c), torch.bfloat16),
                                  ("m", m, (np_, num_heads, k), torch.float32),
                                  ("l", l, (np_, num_heads, k), torch.float32)):
        if t.device != qkv_p.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"patch_attention_bwd: {name} must be {dtype} {shape} on "
                             f"{qkv_p.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"patch_attention_bwd: {name} must be contiguous and 16-byte aligned")
    split, warps, key_tiles, smem = bwd_plan(k, d)
    if smem > SMEM_LIMIT or split > _BWD_MAX_CLUSTER:
        raise ValueError(f"patch_attention_bwd: patch size {k} exceeds shared memory at D={d}")
    dqkv = torch.empty_like(qkv_p)
    if np_ > 0:
        stats = torch.empty((np_, num_heads, k, 2), dtype=torch.float32, device=qkv_p.device)
        fn = build.cfunc(
            "patch_attention_bwd", "patch_attention_bwd",
            [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int,
             c_int, c_int, c_int, c_int, c_int, c_int, c_float, c_void_p],
        )
        status = fn(qkv_p.data_ptr(), out.data_ptr(), dout.data_ptr(), m.data_ptr(), l.data_ptr(),
                    stats.data_ptr(), dqkv.data_ptr(), np_, k, c, num_heads, d, split, warps,
                    key_tiles, float(scale), build.stream_handle(qkv_p.device))
        build.check(status, "patch_attention_bwd")
        patch_attention_bwd.launches += 1
    return dqkv


patch_attention_bwd.launches = 0


class PatchAttention(torch.autograd.Function):
    """Patch attention with the recompute backward: the forward kernel also
    writes the row statistics when a gradient is needed, and the backward
    kernel recomputes p from them. Saved: qkv_p, the output, m and l."""

    @staticmethod
    def forward(ctx, qkv_p: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
        ctx.num_heads, ctx.scale = num_heads, scale
        if not ctx.needs_input_grad[0]:
            return patch_attention_fwd(qkv_p, num_heads, scale)
        out, m, l = patch_attention_fwd(qkv_p, num_heads, scale, stats=True)
        ctx.save_for_backward(qkv_p, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv_p, out, m, l = ctx.saved_tensors
        dqkv = patch_attention_bwd(qkv_p, out, dout.contiguous(), m, l, ctx.num_heads, ctx.scale)
        return dqkv, None, None
