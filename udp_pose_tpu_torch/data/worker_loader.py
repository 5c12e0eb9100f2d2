"""Multiprocess training input: ``torch.utils.data.DataLoader`` workers
over the port's epoch batch plan.

The counterpart of ``udp_pose_tpu/data/grain_loader.py`` (the
reference's ``DataLoader(num_workers=...)``, tools/train.py:145-158):
worker processes run the sample pipeline (decode, crop, augmentation,
targets) and collate whole batches.  The plan is the in-process loader's
own :func:`.base.epoch_batch_indices`, so both loaders visit the same
samples in the same batches.  The augmentation is seeded per record as
the JAX package's grain loader seeds it (``grain_loader.py:41-45``): the
dataset's generator is re-seeded from ``SeedSequence([seed, index])``
before each sample, so a batch does not depend on the worker count or
on which worker builds it.  (The in-process loader draws every sample
from one generator seeded per epoch, so its augmentation differs from
this one's for the same seed, as it does in the JAX package.)

Batches are the in-process loader's: dicts of numpy arrays (meta as
lists), in plan order; :mod:`.prefetch` uploads them.  With
``as_tensors`` the arrays come as CPU tensors, which the workers hand
over in shared memory instead of pickling their bytes through a pipe
(the device augmentation's u8 canvases: 39.3 MB a batch at B=32).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import collate, epoch_batch_indices


def record_seed(seed: int, index: int) -> int:
    """The generator seed of record ``index`` in epoch ``seed`` (the
    grain loader's)."""
    return int(np.random.SeedSequence([int(seed), int(index)])
               .generate_state(1)[0])


class PlannedBatches(torch.utils.data.Dataset):
    """Batch ``i`` of ``plan`` (index chunks) as one item: each record
    built after re-seeding ``dataset`` with :func:`record_seed`, then
    collated.  Pickled to each worker with the dataset."""

    def __init__(self, dataset, plan, seed: int, as_tensors: bool = False):
        self.dataset = dataset
        self.plan = [np.asarray(chunk) for chunk in plan]
        self.seed = int(seed)
        self.as_tensors = as_tensors

    def __len__(self):
        return len(self.plan)

    def __getitem__(self, i):
        samples = []
        for idx in self.plan[i]:
            self.dataset.seed(record_seed(self.seed, idx))
            samples.append(self.dataset[int(idx)])
        batch = collate(samples)
        if self.as_tensors:
            batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                     else v for k, v in batch.items()}
        return batch


def _as_is(batch):
    """The DataLoader's collate for ready batches: keep numpy arrays."""
    return batch


def worker_loader(dataset, batch_size: int, *, seed: int = 0,
                  shuffle: bool = True, num_workers: int = 4,
                  shard_index: int = 0, num_shards: int = 1,
                  multiprocessing_context=None, timeout: float = 0,
                  as_tensors: bool = False):
    """A ``DataLoader`` over epoch ``seed``'s batch plan of ``dataset``
    (:func:`.base.epoch_batch_indices` with the same arguments: full
    batches only, of shard ``shard_index`` of ``num_shards``), whose
    ``num_workers`` processes each build whole batches.  Each record is
    seeded by its index, so the shards of a data-parallel epoch build
    the records a one-process epoch at the same global batch builds.

    ``multiprocessing_context``: how the workers start (None: the
    platform's default, ``fork`` on Linux, right for the trainer, which
    has no other runtime loaded; ``"spawn"`` in a process where forking
    is unsafe, which needs a dataset that pickles).  ``timeout``: seconds
    to wait for a batch before raising (0: forever).  ``as_tensors``:
    the batches' arrays as CPU tensors, passed from the workers in shared
    memory."""
    plan = epoch_batch_indices(dataset, batch_size, shuffle=shuffle,
                               seed=seed, shard_index=shard_index,
                               num_shards=num_shards)
    workers = int(num_workers)
    return torch.utils.data.DataLoader(
        PlannedBatches(dataset, plan, seed, as_tensors), batch_size=None,
        shuffle=False, num_workers=workers, collate_fn=_as_is,
        multiprocessing_context=(multiprocessing_context if workers
                                 else None),
        timeout=timeout if workers else 0)
