"""Ratio-interleaved loading of several datasets (Point Prompt Training's
joint training; counterpart of `pointcept_tpu/datasets/dataloader.py`,
parity target: reference `pointcept/datasets/dataloader.py:26`).

One `DataLoader` a sub-dataset of a `ConcatDataset`, each shuffled with the
seed ``seed + dataset_id`` and dropping its last short batch. Each
sub-dataset's own `loop` becomes its ratio (its loop is then 1, the first
one's the concat's), and a round yields ``ratio_i`` batches of dataset i in
dataset order. The epoch is the first dataset's: it ends when that loader
runs out, and any other loader that runs out first starts over. So
``len()`` is what an epoch yields, ``len(dl_0) // r_0 * sum(r) +
len(dl_0) % r_0``, the count the trainer's schedule takes. The JAX package
counts ``sum(len(dl_i) * r_i)`` but yields ``sum(len(dl_i))`` (each loader
once), and the tail of its epoch is one dataset alone.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..utils.logger import get_root_logger
from .loader import DataLoader


class MultiDatasetDataloader:
    def __init__(self, concat_dataset, batch_size_per_gpu: int, num_worker_per_gpu: int,
                 collate_fn: Optional[Callable] = None, seed: Optional[int] = None, pin_memory: bool = False):
        self.datasets = concat_dataset.datasets
        self.ratios = [int(dataset.loop) for dataset in self.datasets]
        if min(self.ratios) < 1:
            raise ValueError(f"MultiDatasetDataloader: ratios (the sub-datasets' loop) must be at least 1, "
                             f"got {self.ratios}")
        # the interleave realises the ratios; the first dataset sets the epoch
        for dataset in self.datasets:
            dataset.loop = 1
        self.datasets[0].loop = concat_dataset.loop
        self.dataset = concat_dataset
        self.batch_size = batch_size_per_gpu
        logger = get_root_logger()
        self.dataloaders = []
        for dataset_id, dataset in enumerate(self.datasets):
            self.dataloaders.append(DataLoader(
                dataset, batch_size=batch_size_per_gpu, shuffle=True, num_workers=num_worker_per_gpu,
                collate_fn=collate_fn, drop_last=True, seed=(seed or 0) + dataset_id, pin_memory=pin_memory))
            logger.info(f"MultiDataset: sub-dataset {dataset_id} ({type(dataset).__name__}) ratio "
                        f"{self.ratios[dataset_id]}, {len(dataset)} samples, {len(self.dataloaders[-1])} batches")
        if any(len(dl) == 0 for dl in self.dataloaders):
            raise ValueError(f"MultiDatasetDataloader: a sub-dataset holds less than one batch of "
                             f"{batch_size_per_gpu} ({[len(d) for d in self.datasets]} samples)")

    def set_epoch(self, epoch: int):
        for dl in self.dataloaders:
            dl.set_epoch(epoch)

    def __len__(self):
        main, r0 = len(self.dataloaders[0]), self.ratios[0]
        return main // r0 * sum(self.ratios) + main % r0

    def __iter__(self):
        iterators = [iter(dl) for dl in self.dataloaders]
        try:
            while True:
                for i, ratio in enumerate(self.ratios):
                    for _ in range(ratio):
                        try:
                            batch = next(iterators[i])
                        except StopIteration:
                            if i == 0:
                                return
                            iterators[i] = iter(self.dataloaders[i])
                            batch = next(iterators[i])
                        yield batch
        finally:
            for it in iterators:
                it.close()
