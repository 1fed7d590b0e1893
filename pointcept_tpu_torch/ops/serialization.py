"""Space-filling-curve serialization of voxel grids (PyTorch).

Counterpart of `pointcept_tpu/ops/serialization.py`. Public functions keep the
JAX package's layout: codes are int32 key triples ``(batch, hi, lo)`` —
``hi`` holds the curve bits above bit 30, ``lo`` the low 30 bits — so that
tests compare like with like. Sorts fold a triple into one int64
(`fold_keys`: the batch id above bit 48, the code below it) and run one
stable `torch.sort`, which gives the lexicographic order of the triples for
every code of coordinates below 2**16.

Orders: ``z``, ``z-trans`` (x/y swapped), ``hilbert``, ``hilbert-trans``.
Morton bit layout: per level the x bit is most significant,
``key = ... x<<(3i+2) | y<<(3i+1) | z<<3i``; Hilbert is Skilling's transform
followed by the same interleave.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")

# Sentinel batch id for padding slots: sorts after every real scene.
BATCH_SENTINEL = 2**22
# code bits of a folded key: the Morton interleave of three 16-bit coordinates
FOLD_BITS = 48


def _part1by2_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so bit i lands at position 3*i (int32-safe)."""
    x = v & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_encode_pair(x, y, z, depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D Morton code as an int32 (hi, lo) pair; x is the most significant axis."""
    assert depth <= 16, "depth must be <= 16"
    x = x.to(torch.int32)
    y = y.to(torch.int32)
    z = z.to(torch.int32)
    lo = (_part1by2_10(x) << 2) | (_part1by2_10(y) << 1) | _part1by2_10(z)
    if depth > 10:
        hi = (_part1by2_10(x >> 10) << 2) | (_part1by2_10(y >> 10) << 1) | _part1by2_10(z >> 10)
    else:
        hi = torch.zeros_like(lo)
    return hi, lo


def hilbert_transform(x, y, z, depth: int):
    """Skilling's AxesToTranspose on int32 coordinate words: afterwards the
    Morton interleave of (x, y, z) is the Hilbert index."""
    coords = [x.to(torch.int32), y.to(torch.int32), z.to(torch.int32)]
    q = 1 << (depth - 1)
    while q > 1:
        p = q - 1
        for i in range(3):
            cond = (coords[i] & q) != 0
            inverted0 = coords[0] ^ p
            t = (coords[0] ^ coords[i]) & p
            swapped0 = coords[0] ^ t
            swappedi = coords[i] ^ t
            coords[0] = torch.where(cond, inverted0, swapped0)
            if i != 0:
                coords[i] = torch.where(cond, coords[i], swappedi)
        q >>= 1
    coords[1] = coords[1] ^ coords[0]
    coords[2] = coords[2] ^ coords[1]
    t = torch.zeros_like(coords[0])
    q = 1 << (depth - 1)
    while q > 1:
        t = torch.where((coords[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return coords[0] ^ t, coords[1] ^ t, coords[2] ^ t


def encode(grid_coord: torch.Tensor, batch: torch.Tensor, depth: int, order: str = "z") -> torch.Tensor:
    """[N, 3] grid coords + [N] batch ids -> key triples [N, 3] int32."""
    assert order in ORDERS, f"unknown order {order}"
    if order.endswith("-trans"):
        x, y, z = grid_coord[:, 1], grid_coord[:, 0], grid_coord[:, 2]
    else:
        x, y, z = grid_coord[:, 0], grid_coord[:, 1], grid_coord[:, 2]
    if order.startswith("hilbert"):
        x, y, z = hilbert_transform(x, y, z, depth)
    hi, lo = morton_encode_pair(x, y, z, depth)
    return torch.stack([batch.to(torch.int32), hi, lo], dim=-1)


def key_shift_right(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Right-shift the (hi, lo) curve code of key triples by `bits` (batch kept)."""
    if bits == 0:
        return keys
    assert 0 < bits < 30
    b, hi, lo = keys[..., 0], keys[..., 1], keys[..., 2]
    new_lo = ((lo >> bits) & ((1 << (30 - bits)) - 1)) | ((hi & ((1 << bits) - 1)) << (30 - bits))
    new_hi = hi >> bits
    return torch.stack([b, new_hi, new_lo], dim=-1)


def fold_keys(keys: torch.Tensor) -> torch.Tensor:
    """Key triples -> int64 with the same order: ``batch << 48 | code``.

    The batch id sits above every code the encoders make of coordinates
    below 2**16 (48 bits: 18 in ``hi``, 30 in ``lo``), whatever `depth` the
    keys were encoded at: a code beyond ``3 * depth`` bits (a coordinate
    past ``2**depth``) must not reach the batch's bits, or one scene's keys
    would sort among another's. Batch ids at or above the sentinel are
    remapped just below the int64 limit (real batch ids stay below 2**15 - 2)."""
    bmax = (1 << (63 - FOLD_BITS)) - 1
    b = keys[..., 0].to(torch.int64)
    b = torch.where(b >= BATCH_SENTINEL, b - BATCH_SENTINEL + (bmax - 1), b)
    code = (keys[..., 1].to(torch.int64) << 30) | keys[..., 2].to(torch.int64)
    return (b << FOLD_BITS) | code


def argsort_keys(keys: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
    """Lexicographic argsort of key triples [N, 3] -> order [N] int32.

    Stable, so ties (padding rows only: valid keys are unique) keep their
    input order. `depth`: the JAX package's signature; the fold needs none."""
    return torch.sort(fold_keys(keys), stable=True).indices.to(torch.int32)


def invert_order(order: torch.Tensor) -> torch.Tensor:
    """inverse[order[i]] = i."""
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return inv


def keys_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise equality of key triples -> bool over leading dims."""
    return (a == b).all(dim=-1)
