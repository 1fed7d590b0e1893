"""Host-side clustering of PointGroup's proposals (counterpart of `bfs_cluster`
in `pointcept_tpu/ops/clustering.py`; the reference's
`libs/pointgroup_ops` ``ballquery_batch_p`` + ``bfs_cluster``, which also
run on the CPU).

`bfs_cluster` calls the port's own C++ (`csrc/clustering.cpp`), built with
`g++` into ``build/kernels/`` at first use by `ops/kernels/build.py`; it
raises when the library does not build. `bfs_cluster_plain` is the same
search in numpy, for the tests: it is never called in its place.

ScanNet++'s superpoints (the JAX package's `segment_graph`,
`segment_mesh`) serve its preprocessing alone and are not ported here.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int32,
             ctypes.c_int32, ctypes.c_void_p]


def _library():
    from .kernels.build import load_host

    fn = load_host("clustering").bfs_cluster
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _inputs(coords, batch, labels):
    return (np.ascontiguousarray(coords, np.float32), np.ascontiguousarray(batch, np.int32),
            np.ascontiguousarray(labels, np.int32))


def bfs_cluster(coords: np.ndarray, batch: np.ndarray, labels: np.ndarray, radius: float, min_points: int = 50,
                max_neighbors: int = 300) -> Tuple[np.ndarray, int]:
    """Connected components of the fixed-`radius` graph over `coords` [n, 3]
    (voxel units), within one `batch` id and one `labels` class; each point
    adds at most `max_neighbors` neighbours; components under `min_points`
    are dropped. Returns (cluster id [n] int32, -1 where none; the number of
    clusters), ids in the order of each cluster's first point."""
    coords, batch, labels = _inputs(coords, batch, labels)
    n = coords.shape[0]
    out = np.empty(n, np.int32)
    num = _library()(coords.ctypes.data, batch.ctypes.data, labels.ctypes.data, n, float(radius), int(min_points),
                     int(max_neighbors), out.ctypes.data)
    return out, int(num)


def bfs_cluster_plain(coords: np.ndarray, batch: np.ndarray, labels: np.ndarray, radius: float,
                      min_points: int = 50, max_neighbors: int = 300) -> Tuple[np.ndarray, int]:
    """`bfs_cluster` in numpy (quadratic; tests only): the same grid cells
    (16 bits an axis, wrapped), visiting order, neighbour cap and seeds."""
    coords, batch, labels = _inputs(coords, batch, labels)
    n = coords.shape[0]
    r2 = np.float32(radius) * np.float32(radius)
    inv_r = np.float32(1.0) / np.float32(radius)
    cells = np.floor(coords * inv_r).astype(np.int64)
    key = lambda c, b: (int(b), int(c[0]) & 0xFFFF, int(c[1]) & 0xFFFF, int(c[2]) & 0xFFFF)  # noqa: E731
    grid = {}
    for i in range(n):
        grid.setdefault(key(cells[i], batch[i]), []).append(i)
    out = np.full(n, -1, np.int64)
    num = 0
    for seed in range(n):
        if out[seed] != -1:
            continue
        component, stack = [], [seed]
        out[seed] = -2
        lbl, bat = labels[seed], batch[seed]
        while stack:
            i = stack.pop()
            component.append(i)
            found = 0
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        if found >= max_neighbors:
                            break
                        for j in grid.get(key(cells[i] + (dx, dy, dz), bat), ()):
                            if out[j] != -1 or labels[j] != lbl:
                                continue
                            e = coords[j] - coords[i]
                            if e[0] * e[0] + e[1] * e[1] + e[2] * e[2] <= r2:
                                out[j] = -2
                                stack.append(j)
                                found += 1
                                if found >= max_neighbors:
                                    break
        if len(component) >= min_points:
            out[component] = num
            num += 1
        else:
            out[component] = -1 - 1000000
    return np.where(out < -1, -1, out).astype(np.int32), num
