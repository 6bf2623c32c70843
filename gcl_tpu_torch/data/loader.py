"""Batches of host samples (port of gcl_tpu/data/loader.py and
gcl_tpu/data/__init__.py:make_data_loader) on torch.utils.data.

Samples are dicts of numpy arrays; ``collate_stack`` stacks each array
field along a new batch axis and gathers the rest (a sample's 'meta')
into lists. ``DataLoader`` keeps gcl_tpu's order and batching: the same
index batches (a shuffle by np.random.RandomState(epoch), the last
short batch dropped or kept), handed to torch.utils.data.DataLoader as
its batch sampler, with worker processes where asked for.

Data-parallel ranks share the train loader's order: every rank shuffles
with the same seed and keeps its contiguous slice of each global batch,
rank r of n the samples [r * B / n, (r + 1) * B / n), as gcl_tpu's
loader does for its hosts (and as its mesh lays a global batch over its
devices).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch.utils.data

from .colocation import ColocationKittiDataset, ColocationNuscenesDataset
from .pairs import PairComplementKittiDataset, PairComplementNuscenesDataset

ALL_DATASETS = {d.__name__: d for d in (
    ColocationKittiDataset, ColocationNuscenesDataset,
    PairComplementKittiDataset, PairComplementNuscenesDataset)}


def collate_stack(samples: List[Dict]) -> Dict:
    """Stack each array field along a new leading axis; other fields are
    collected into lists."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) \
                or isinstance(vals[0], np.generic):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class DataLoader:
    """Iterable over collated batches in gcl_tpu's order. num_workers=0
    reads in-process; with workers, torch.utils.data's processes (started
    by spawn, so the dataset must pickle) read the samples
    and the batches come in order.

    ``shard_id`` / ``num_shards``: this rank's slice of every global batch
    of ``batch_size`` samples (which num_shards must divide); the loader's
    length and ``batch_size`` stay the global ones."""

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=0,
                 drop_last=False, shard_id=0, num_shards=1):
        if batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.shard_id, self.num_shards = shard_id, num_shards
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self._epoch).shuffle(order)
        self._epoch += 1
        batches = [order[i:i + self.batch_size].tolist()
                   for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_shards > 1:
            per = self.batch_size // self.num_shards
            lo = self.shard_id * per
            batches = [b[lo:lo + per] for b in batches if b[lo:lo + per]]
        return batches

    def __iter__(self):
        # workers start by spawn: forking a process that runs threads (the
        # CUDA runtime, a thread pool) is unsafe
        return iter(torch.utils.data.DataLoader(
            self.dataset, batch_sampler=self._index_batches(),
            num_workers=self.num_workers, collate_fn=collate_stack,
            multiprocessing_context="spawn" if self.num_workers else None))


def make_data_loader(config, phase, batch_size, num_threads=0, shuffle=None,
                     shard=(0, 1)):
    """gcl_tpu's loader dispatch: the train phase's dataset from
    config.train_dataset (a colocation dataset for GCL, a pair dataset for
    FCGF), val and test from config.dataset; augmentation flags from the
    config in the train phase only; the train phase shuffled with its last
    short batch dropped. ``shard`` = (rank, world size): a data-parallel
    rank's slice of each train batch (other phases are not sharded)."""
    assert phase in ("train", "val", "test")
    if shuffle is None:
        shuffle = phase != "test"
    name = (getattr(config, "train_dataset", config.dataset)
            if phase == "train" else config.dataset)
    if name not in ALL_DATASETS:
        raise ValueError(
            f"dataset {name!r} is not in gcl_tpu_torch, which has "
            f"{sorted(ALL_DATASETS)} (the legacy FCGF datasets are ROADMAP "
            f"Queue 1 item 6)")
    train = phase == "train"
    dataset = ALL_DATASETS[name](
        phase, transform=None,
        random_rotation=train and config.use_random_rotation,
        random_scale=train and config.use_random_scale,
        manual_seed=not train, config=config)
    shard_id, num_shards = shard if train else (0, 1)
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_workers=num_threads, drop_last=train,
                      shard_id=shard_id, num_shards=num_shards)
