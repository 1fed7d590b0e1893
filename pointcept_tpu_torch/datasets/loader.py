"""Multiprocess prefetching DataLoader (counterpart of
`pointcept_tpu/datasets/loader.py`).

Worker processes run ``dataset[idx]`` and the collate and stream the batches
back in order; ``num_workers=0`` iterates in the calling process. The index
shuffle of an epoch is ``RandomState(seed + epoch)``'s, and before each batch
`np.random` and `random` are seeded with ``seed + epoch * 7919 + batch_idx``,
in a worker or not, as the JAX package does: one seed gives the same batches
there and here. With `pin_memory` the collated arrays arrive as pinned host
tensors, so that the step's copies to the card can be ``non_blocking``.

Workers are forked from a process that holds CUDA state. Python's garbage
collector is frozen across the fork, so a worker never collects an object
it inherited (one that holds a CUDA tensor would call into CUDA from the
child and abort it), and a worker that dies raises in the parent rather
than leaving it waiting for its batches.
"""

from __future__ import annotations

import gc
import multiprocessing as mp
import queue
import random
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch


def _seed_batch(seed: int, epoch: int, batch_idx: int) -> None:
    s = (seed + epoch * 7919 + batch_idx) % (2**31)
    np.random.seed(s)
    random.seed(s)


def _worker_loop(dataset, collate_fn, task_q, result_q, base_seed):
    while True:
        task = task_q.get()
        if task is None:
            break
        batch_idx, indices, epoch = task
        _seed_batch(base_seed, epoch, batch_idx)
        try:
            samples = [dataset[i] for i in indices]
            result_q.put((batch_idx, collate_fn(samples) if collate_fn is not None else samples, None))
        except Exception:
            result_q.put((batch_idx, None, traceback.format_exc()))


def pin(batch):
    """numpy arrays of a collated batch -> pinned host tensors (other values
    as they are)."""
    if not isinstance(batch, dict):
        return batch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, num_workers: int = 0,
                 collate_fn: Optional[Callable] = None, drop_last: bool = False, seed: Optional[int] = None,
                 prefetch: int = 4, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.seed = seed if seed is not None else 0
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self) -> List[List[int]]:
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.RandomState((self.seed + self.epoch) % 2**31).shuffle(indices)
        batches = [indices[i : i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        batches = self._index_batches()
        it = self._serial_iter(batches) if self.num_workers == 0 else self._parallel_iter(batches)
        for batch in it:
            yield pin(batch) if self.pin_memory else batch

    def _serial_iter(self, batches):
        for bi, idxs in enumerate(batches):
            _seed_batch(self.seed, self.epoch, bi)
            samples = [self.dataset[i] for i in idxs]
            yield self.collate_fn(samples) if self.collate_fn is not None else samples

    def _parallel_iter(self, batches):
        ctx = mp.get_context("fork")
        task_q = ctx.Queue()
        result_q = ctx.Queue(maxsize=max(self.prefetch, self.num_workers))
        workers = []
        gc.collect()
        gc.freeze()
        try:
            for _ in range(self.num_workers):
                p = ctx.Process(target=_worker_loop,
                                args=(self.dataset, self.collate_fn, task_q, result_q, self.seed), daemon=True)
                p.start()
                workers.append(p)
        finally:
            gc.unfreeze()
        try:
            for bi, idxs in enumerate(batches):
                task_q.put((bi, idxs, self.epoch))
            for _ in workers:
                task_q.put(None)
            buffered, next_idx = {}, 0
            for _ in range(len(batches)):
                while True:
                    try:
                        bi, batch, err = result_q.get(timeout=5)
                        break
                    except queue.Empty:
                        dead = [p.exitcode for p in workers if p.exitcode not in (None, 0)]
                        if dead:
                            raise RuntimeError(f"DataLoader worker died (exit code {dead[0]})") from None
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed:\n{err}")
                buffered[bi] = batch
                while next_idx in buffered:
                    yield buffered.pop(next_idx)
                    next_idx += 1
        finally:
            for p in workers:
                if p.is_alive():
                    p.terminate()
            for p in workers:
                p.join(timeout=5)
