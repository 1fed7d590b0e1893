"""Patch attention: the CUDA kernels `csrc/patch_attention.cu` (forward) and
`csrc/patch_attention_bwd.cu` (backward), their plain PyTorch versions, and the
`PatchAttention` autograd function that joins them.

Replaces `_fwd_kernel_kmajor`, `_fwd_kernel`, and the backward kernels
`_bwd_kernel_kmajor`, `_bwd_kernel_kmajor_chunked`, `_bwd_kernel`,
`_bwd_kernel_chunked` (pointcept_tpu/ops/pallas/flash_attention.py). A tensor
on the CPU takes the plain version; a CUDA tensor launches the kernel or raises.

With ``rpe=(table, coords)`` (PT-v3m1's relative position encoding) both
kernels add a per-score bias: ``table`` [3 * (2b + 1), H] f32 read at each
(query, key) pair's clipped relative grid coordinate (``coords`` [nP, K, 3]
int32, the slots' grid coordinates) and summed over the three axes, the
JAX package's `RPE` (pointcept_tpu/models/point_transformer_v3); the
backward also returns the table's gradient. These score-biased instances
of the two sources are built as libraries of their own
(`csrc/patch_attention_rpe.cu`, `csrc/patch_attention_bwd_rpe.cu`). The
TPU kernels take no bias (the JAX package runs RPE on its dense path). The
biased launches count in `patch_attention_rpe_fwd.launches` and
`patch_attention_rpe_bwd.launches`, apart from the unbiased ones.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper (227 KB)
_BWD_STEP = 64  # queries a warp of the backward handles in one step
_BWD_MAX_CLUSTER = 8  # the portable cluster size


def rpe_bound(patch_size: int) -> int:
    """The RPE table's clip bound b at a patch size: ``int((4K)^(1/3) * 2)``,
    computed in floating point as the reference does (15 at K = 128, where
    512^(1/3) is 7.999...; 31 at K = 1024)."""
    return int((4 * patch_size) ** (1 / 3) * 2)


def _rpe_bins(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """coords [p, K, 3] -> each (query, key) pair's three table rows
    [p, K, K, 3]: the clipped query-minus-key coordinate of each axis,
    shifted to its axis's block of 2b + 1 rows."""
    nb = table.shape[0] // 3
    b = (nb - 1) // 2
    rel = coords[:, :, None, :].long() - coords[:, None, :, :].long()
    return rel.clamp(-b, b) + b + torch.arange(3, device=coords.device) * nb


def rpe_lookup(table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The RPE bias [p, H, K, K] f32 of the slots' coordinates [p, K, 3]:
    the three axes' table rows summed (x, then y, then z)."""
    idx = _rpe_bins(table, coords)
    bias = table[idx[..., 0]] + table[idx[..., 1]] + table[idx[..., 2]]  # [p, K, K, H]
    return bias.permute(0, 3, 1, 2)


def patch_attention_fwd_plain(qkv_p: torch.Tensor, num_heads: int, scale: float,
                              chunk: int = 8, stats: bool = False, rpe=None):
    """qkv_p [nP, K, 3C] -> [nP, K, C] in qkv_p's dtype; with `stats` also
    the f32 row max m and denominator l, [nP, H, K] each; with ``rpe=(table,
    coords)`` the RPE bias added to each scaled score.

    The kernel's arithmetic: f32 scores of the stored operands, a softmax
    over the whole patch, p rounded to the input dtype before p . v, and the
    f32 denominator of the unrounded p applied last. `chunk` patches at a
    time bound the [chunk, H, K, K] f32 score block."""
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    h = num_heads
    d = c // h
    if rpe is not None:
        _check_rpe(rpe, qkv_p, h, "patch_attention_fwd_plain")
        table, coords = rpe
    out = torch.empty((np_, k, c), dtype=qkv_p.dtype, device=qkv_p.device)
    m_all = torch.empty((np_, h, k), dtype=torch.float32, device=qkv_p.device)
    l_all = torch.empty_like(m_all)
    for p0 in range(0, np_, chunk):
        x = qkv_p[p0 : p0 + chunk].reshape(-1, k, 3, h, d)
        q, kk, v = (x[:, :, i].float() for i in range(3))
        s = torch.einsum("pkhd,pmhd->phkm", q, kk) * scale
        if rpe is not None:
            s = s + rpe_lookup(table, coords[p0 : p0 + chunk])
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        denom = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("phkm,pmhd->phkd", e.to(qkv_p.dtype).float(), v) / denom
        out[p0 : p0 + chunk] = o.permute(0, 2, 1, 3).reshape(-1, k, c).to(qkv_p.dtype)
        m_all[p0 : p0 + chunk] = m[..., 0]
        l_all[p0 : p0 + chunk] = denom[..., 0]
    return (out, m_all, l_all) if stats else out


def _check_rpe(rpe, qkv_p: torch.Tensor, num_heads: int, what: str) -> int:
    """Validates a kernel's ``rpe=(table, coords)``; returns the clip bound b."""
    table, coords = rpe
    np_, k, _ = qkv_p.shape
    nb = table.shape[0] // 3 if table.dim() == 2 else 0
    if (table.dim() != 2 or table.shape[1] != num_heads or table.shape[0] != 3 * nb or nb % 2 != 1
            or table.dtype != torch.float32):
        raise ValueError(f"{what}: the RPE table must be f32 [3 * (2b + 1), {num_heads}], "
                         f"got {table.dtype} {tuple(table.shape)}")
    if coords.dtype != torch.int32 or tuple(coords.shape) != (np_, k, 3):
        raise ValueError(f"{what}: the RPE coordinates must be int32 [{np_}, {k}, 3], "
                         f"got {coords.dtype} {tuple(coords.shape)}")
    for name, t in (("table", table), ("coords", coords)):
        if t.device != qkv_p.device or not t.is_contiguous():
            raise ValueError(f"{what}: the RPE {name} must be contiguous on {qkv_p.device}")
    return (nb - 1) // 2


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
    if c % num_heads != 0 or (c // num_heads) not in (4, 8, 16, 18, 24, 32):
        raise ValueError(f"{what}: head dim {c}/{num_heads} must be 4, 8, 16, 18, 24 or 32")
    if qkv_p.shape[1] % 16 != 0:
        raise ValueError(f"{what}: patch size {qkv_p.shape[1]} must be a multiple of 16")
    return c // num_heads


# head dims the kernels take on zero-padded heads: 4 and 8 run the D = 16
# kernels, 18 (Utonia's) the D = 24 ones. The zero columns add nothing to
# q . k, and their output and gradient columns are dropped; the caller's
# scale (1 / sqrt(4), 1 / sqrt(8) or 1 / sqrt(18)) is passed on unchanged.
_PAD_WIDTH = {4: 16, 8: 16, 18: 24}


def _pad_heads(x: torch.Tensor, num_heads: int, parts: int, width: int = 16) -> torch.Tensor:
    """[nP, K, parts * H * d] -> [nP, K, parts * H * width], each head's d
    columns followed by width - d zeros."""
    np_, k, _ = x.shape
    x = x.reshape(np_, k, parts, num_heads, x.shape[2] // (parts * num_heads))
    return F.pad(x, (0, width - x.shape[-1])).reshape(np_, k, parts * num_heads * width)


def _unpad_heads(x: torch.Tensor, num_heads: int, parts: int, d: int) -> torch.Tensor:
    np_, k, _ = x.shape
    return x.reshape(np_, k, parts, num_heads, _PAD_WIDTH[d])[..., :d].reshape(np_, k, parts * num_heads * d)


def attention_sizes(np_: int, k: int, c: int, num_heads: int) -> None:
    """The kernels' int range: elements of the packed rows and of the row
    statistics (raises past 2^31 - 1)."""
    build.check_int32("patch_attention", qkv_elements=np_ * k * 3 * c, stats_elements=np_ * num_heads * k * 2)


def _fwd(qkv_p: torch.Tensor, num_heads: int, scale: float, stats: bool, rpe, counter) -> tuple:
    """The forward kernel's launch (`counter`: the wrapper whose count it
    adds to) -> (out, m, l), m and l None without `stats`."""
    what = counter.__name__
    d = _check(qkv_p, num_heads, what)
    bnd = None if rpe is None else _check_rpe(rpe, qkv_p, num_heads, what)
    if d in _PAD_WIDTH:
        out, m, l = _fwd(_pad_heads(qkv_p, num_heads, 3, _PAD_WIDTH[d]), num_heads, scale, stats, rpe, counter)
        return _unpad_heads(out, num_heads, 1, d), m, l
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    attention_sizes(np_, k, c, num_heads)
    bins = 0 if rpe is None else 3 * (2 * bnd + 1)
    if fwd_shared_memory(k, d, bins) > SMEM_LIMIT:
        raise ValueError(f"{what}: patch size {k} exceeds shared memory at D={d}")
    out = torch.empty((np_, k, c), dtype=qkv_p.dtype, device=qkv_p.device)
    m = l = None
    if stats:
        m = torch.empty((np_, num_heads, k), dtype=torch.float32, device=qkv_p.device)
        l = torch.empty_like(m)
    if np_ > 0:
        fn = build.cfunc(
            "patch_attention" if rpe is None else "patch_attention_rpe", "patch_attention_fwd",
            [c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_float,
             c_void_p, c_void_p, c_int, c_void_p],
        )
        status = fn(qkv_p.data_ptr(), out.data_ptr(), 0 if m is None else m.data_ptr(),
                    0 if l is None else l.data_ptr(), np_, k, c, num_heads, d, float(scale),
                    0 if rpe is None else rpe[0].data_ptr(), 0 if rpe is None else rpe[1].data_ptr(),
                    0 if rpe is None else bnd, build.stream_handle(qkv_p.device))
        build.check(status, what)
        counter.launches += 1
    return out, m, l


def patch_attention_fwd(qkv_p: torch.Tensor, num_heads: int, scale: float, stats: bool = False):
    """qkv_p [nP, K, 3C] slot-gathered rows (q | k | v, head-major within
    each) -> [nP, K, C]; with `stats` also the row statistics m, l that
    `patch_attention_bwd` takes. On CUDA: bf16, contiguous, head dim 4, 8,
    16, 18, 24 or 32 (4, 8 and 18 on zero-padded heads), K a multiple of 16."""
    if qkv_p.device.type == "cpu":
        return patch_attention_fwd_plain(qkv_p, num_heads, scale, stats=stats)
    out, m, l = _fwd(qkv_p, num_heads, scale, stats, None, patch_attention_fwd)
    return (out, m, l) if stats else out


def patch_attention_rpe_fwd(qkv_p: torch.Tensor, num_heads: int, scale: float, table: torch.Tensor,
                            coords: torch.Tensor, stats: bool = False):
    """`patch_attention_fwd` with the RPE bias of `table` [3 * (2b + 1), H]
    f32 at the slots' grid coordinates `coords` [nP, K, 3] int32 (on CUDA:
    both contiguous, on qkv_p's device)."""
    if qkv_p.device.type == "cpu":
        return patch_attention_fwd_plain(qkv_p, num_heads, scale, stats=stats, rpe=(table, coords))
    out, m, l = _fwd(qkv_p, num_heads, scale, stats, (table, coords), patch_attention_rpe_fwd)
    return (out, m, l) if stats else out


patch_attention_fwd.launches = 0
patch_attention_rpe_fwd.launches = 0


def patch_attention_bwd_plain(qkv_p: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                              m: torch.Tensor, l: torch.Tensor, num_heads: int, scale: float,
                              chunk: int = 8, rpe=None):
    """The backward kernel's arithmetic step by step -> dqkv [nP, K, 3C] in
    qkv_p's dtype; with ``rpe=(table, coords)`` -> (dqkv, the table's
    gradient [3 * (2b + 1), H] f32).

    p = exp(s - m) * (1 / l) in f32 (the forward's unrounded p, s with the
    bias), the row term rowsum(dO o O) from the forward's stored output,
    dS = p (dP - row) scale; p and dS are rounded to qkv_p's dtype as
    operands of dV = p^T dO, dQ = dS K and dK = dS^T Q, every product
    accumulates in f32. The table's gradient sums the unrounded p (dP - row)
    of each axis's bin (`index_add_`, in order on the CPU)."""
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    h = num_heads
    d = c // h
    dt = qkv_p.dtype
    dqkv = torch.empty_like(qkv_p)
    if rpe is not None:
        _check_rpe(rpe, qkv_p, h, "patch_attention_bwd_plain")
        table, coords = rpe
        dtable = torch.zeros(table.shape, dtype=torch.float32, device=qkv_p.device)
    for p0 in range(0, np_, chunk):
        x = qkv_p[p0 : p0 + chunk].reshape(-1, k, 3, h, d)
        q, kk, v = (x[:, :, i].float() for i in range(3))
        do = dout[p0 : p0 + chunk].reshape(-1, k, h, d).float()
        o = out[p0 : p0 + chunk].reshape(-1, k, h, d).float()
        row = (do * o).sum(dim=-1).permute(0, 2, 1)[..., None]  # [p, h, k, 1]
        s = torch.einsum("pkhd,pmhd->phkm", q, kk) * scale
        if rpe is not None:
            s = s + rpe_lookup(table, coords[p0 : p0 + chunk])
        p = torch.exp(s - m[p0 : p0 + chunk, ..., None]) * (1.0 / l[p0 : p0 + chunk, ..., None])
        dp = torch.einsum("pkhd,pmhd->phkm", do, v)
        if rpe is not None:
            dsb = (p * (dp - row)).permute(0, 2, 3, 1).reshape(-1, h)  # [p * K * K, H]
            idx = _rpe_bins(table, coords[p0 : p0 + chunk]).reshape(-1, 3)
            for axis in range(3):
                dtable.index_add_(0, idx[:, axis], dsb)
        ds = (p * (dp - row) * scale).to(dt).float()
        dq = torch.einsum("phkm,pmhd->pkhd", ds, kk)
        dk = torch.einsum("phkm,pkhd->pmhd", ds, q)
        dv = torch.einsum("phkm,pkhd->pmhd", p.to(dt).float(), do)
        dqkv[p0 : p0 + chunk] = torch.stack([dq, dk, dv], dim=2).reshape(-1, k, c3).to(dt)
    return dqkv if rpe is None else (dqkv, dtable)


def fwd_shared_memory(k: int, d: int, bins: int = 0) -> int:
    """Bytes of shared memory a forward block takes: K and V of one
    (patch, head), bf16, unpadded; with an RPE table of `bins` rows also
    the keys' coordinates (16 bytes a key) and the head's table column."""
    return 2 * k * d * 2 + (16 * k + 4 * bins if bins else 0)


def _rpe_bwd_plan(k: int, d: int, bins: int):
    """(S, W, T, shared memory bytes) of the biased backward: its blocks
    also hold each query's coordinates (16 bytes), the table column and a
    [bins, threads] f32 tile of the table's gradient, so the plan takes the
    most warps that fit: one key tile a warp first (the fewest registers),
    then `bwd_plan`'s T; None where no plan of at most 8 blocks a cluster
    fits in shared memory."""
    kp = -(-k // _BWD_STEP) * _BWD_STEP
    base = kp * (2 * d * 2 + 8 + d * 4) + 16 * kp + 16 * (-(-bins // 4))
    fast = 4 if d == 16 and k % 64 == 0 else 2 if d == 24 and k % 32 == 0 else 1
    for t in dict.fromkeys((1, fast)):
        tiles = k // (16 * t)
        for w in range(min(8 if t > 1 or d > 16 else 16, kp // _BWD_STEP), 0, -1):
            s = -(-tiles // w)
            w = -(-tiles // s)
            smem = base + bins * 32 * w * 4
            if s <= _BWD_MAX_CLUSTER and smem <= SMEM_LIMIT:
                return s, w, t, smem
    return None


def bwd_plan(k: int, d: int):
    """(S, W, T, shared memory bytes) of the backward kernel at patch size k
    and head dim d: S blocks (one cluster) split the k keys of a (patch,
    head), W warps a block own T key tiles of 16 each: four at D = 16 where
    k is a multiple of 64, two at D = 24 where k is a multiple of 32 (each
    Q and dO fragment read from shared memory, and each dQ update, then
    serves 64 or 32 keys; at most 8 warps, for the registers), else one. A
    block holds Q and dO of the whole patch (bf16), each query's lse2 and
    row term (an f32 pair) and an f32 dQ tile, over k rounded up to whole
    64-query tiles. W is at most 16 (D = 16) or 8 (D = 24 and 32: more
    registers a warp; at K = 1024, D = 24 the 200 KB block takes one SM
    alone, and a cluster of 4 such blocks splits the keys) and at most the
    number of query tiles, since warp w handles tile (i + w) mod tiles at
    its i-th step."""
    kp = -(-k // _BWD_STEP) * _BWD_STEP
    t = 4 if d == 16 and k % 64 == 0 else 2 if d == 24 and k % 32 == 0 else 1
    tiles = k // (16 * t)
    w = min(8 if t > 1 or d > 16 else 16, kp // _BWD_STEP)
    s = -(-tiles // w)
    w = -(-tiles // s)
    return s, w, t, kp * (2 * d * 2 + 8 + d * 4)


def _bwd(qkv_p, out, dout, m, l, num_heads: int, scale: float, rpe, counter):
    """The backward kernel's launch (`counter`: the wrapper whose count it
    adds to) -> (dqkv, the table's gradient or None)."""
    what = counter.__name__
    d = _check(qkv_p, num_heads, what)
    bnd = None if rpe is None else _check_rpe(rpe, qkv_p, num_heads, what)
    np_, k, c3 = qkv_p.shape
    c = c3 // 3
    for name, t, shape, dtype in (("out", out, (np_, k, c), torch.bfloat16),
                                  ("dout", dout, (np_, k, c), torch.bfloat16),
                                  ("m", m, (np_, num_heads, k), torch.float32),
                                  ("l", l, (np_, num_heads, k), torch.float32)):
        if t.device != qkv_p.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape} on "
                             f"{qkv_p.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    if d in _PAD_WIDTH:
        w = _PAD_WIDTH[d]
        dqkv, dtable = _bwd(_pad_heads(qkv_p, num_heads, 3, w), _pad_heads(out, num_heads, 1, w),
                            _pad_heads(dout, num_heads, 1, w), m, l, num_heads, scale, rpe, counter)
        return _unpad_heads(dqkv, num_heads, 3, d), dtable
    attention_sizes(np_, k, c, num_heads)
    bins = 0 if rpe is None else 3 * (2 * bnd + 1)
    plan = bwd_plan(k, d) if rpe is None else _rpe_bwd_plan(k, d, bins)
    if plan is None or plan[3] > SMEM_LIMIT or plan[0] > _BWD_MAX_CLUSTER:
        raise ValueError(f"{what}: patch size {k} exceeds shared memory at D={d}"
                         + ("" if rpe is None else f" with an RPE table of {bins} rows"))
    split, warps, key_tiles, _ = plan
    dqkv = torch.empty_like(qkv_p)
    dtable = None
    if rpe is not None:
        dtable = torch.zeros((bins, num_heads), dtype=torch.float32, device=qkv_p.device)
    if np_ > 0:
        stats = torch.empty((np_, num_heads, k, 2), dtype=torch.float32, device=qkv_p.device)
        # each block's partial of the table's gradient: [nP, H, S, bins]
        part = None if rpe is None else torch.empty((np_, num_heads, split, bins), dtype=torch.float32,
                                                    device=qkv_p.device)
        fn = build.cfunc(
            "patch_attention_bwd" if rpe is None else "patch_attention_bwd_rpe", "patch_attention_bwd",
            [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int,
             c_int, c_int, c_int, c_int, c_int, c_int, c_float, c_void_p, c_void_p, c_int, c_void_p,
             c_void_p],
        )
        status = fn(qkv_p.data_ptr(), out.data_ptr(), dout.data_ptr(), m.data_ptr(), l.data_ptr(),
                    stats.data_ptr(), dqkv.data_ptr(), np_, k, c, num_heads, d, split, warps,
                    key_tiles, float(scale), 0 if rpe is None else rpe[0].data_ptr(),
                    0 if rpe is None else rpe[1].data_ptr(), 0 if rpe is None else bnd,
                    0 if part is None else part.data_ptr(), build.stream_handle(qkv_p.device))
        build.check(status, what)
        counter.launches += 1
        if part is not None:
            # a fixed-order reduction over the patches and the cluster's blocks
            dtable = part.sum(dim=(0, 2)).t().contiguous()
    return dqkv, dtable


def patch_attention_bwd(qkv_p: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                        m: torch.Tensor, l: torch.Tensor, num_heads: int,
                        scale: float) -> torch.Tensor:
    """As `patch_attention_bwd_plain`: qkv_p [nP, K, 3C], the forward's output
    `out` and its cotangent `dout` [nP, K, C], its row statistics m, l
    [nP, H, K] -> dqkv [nP, K, 3C]. On CUDA: bf16 rows, f32 statistics, all
    contiguous."""
    if qkv_p.device.type == "cpu":
        return patch_attention_bwd_plain(qkv_p, out, dout, m, l, num_heads, scale)
    return _bwd(qkv_p, out, dout, m, l, num_heads, scale, None, patch_attention_bwd)[0]


def patch_attention_rpe_bwd(qkv_p: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                            m: torch.Tensor, l: torch.Tensor, num_heads: int, scale: float,
                            table: torch.Tensor, coords: torch.Tensor):
    """`patch_attention_bwd` of the biased forward `patch_attention_rpe_fwd`
    -> (dqkv [nP, K, 3C], the table's gradient [3 * (2b + 1), H] f32), the
    same bits on every run."""
    if qkv_p.device.type == "cpu":
        return patch_attention_bwd_plain(qkv_p, out, dout, m, l, num_heads, scale, rpe=(table, coords))
    return _bwd(qkv_p, out, dout, m, l, num_heads, scale, (table, coords), patch_attention_rpe_bwd)


patch_attention_bwd.launches = 0
patch_attention_rpe_bwd.launches = 0


class PatchAttention(torch.autograd.Function):
    """Patch attention with the recompute backward: the forward kernel also
    writes the row statistics when a gradient is needed, and the backward
    kernel recomputes p from them. Saved: qkv_p, the output, m and l (and
    the RPE table and coordinates). With an RPE `table` and `coords` the
    biased kernels run, and the backward also returns the table's
    gradient."""

    @staticmethod
    def forward(ctx, qkv_p: torch.Tensor, num_heads: int, scale: float, table: Optional[torch.Tensor] = None,
                coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx.num_heads, ctx.scale = num_heads, scale
        grad = ctx.needs_input_grad[0] or (table is not None and ctx.needs_input_grad[3])
        if table is None:
            res = patch_attention_fwd(qkv_p, num_heads, scale, stats=grad)
        else:
            res = patch_attention_rpe_fwd(qkv_p, num_heads, scale, table, coords, stats=grad)
        if not grad:
            return res
        out, m, l = res
        ctx.save_for_backward(qkv_p, out, m, l, table, coords)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv_p, out, m, l, table, coords = ctx.saved_tensors
        if table is None:
            dqkv = patch_attention_bwd(qkv_p, out, dout.contiguous(), m, l, ctx.num_heads, ctx.scale)
            return dqkv, None, None, None, None
        dqkv, dtable = patch_attention_rpe_bwd(qkv_p, out, dout.contiguous(), m, l, ctx.num_heads, ctx.scale,
                                               table, coords)
        return dqkv, None, None, dtable.to(table.dtype), None
