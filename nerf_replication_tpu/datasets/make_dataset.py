"""Dataset + loader factory.

Capability parity with reference src/datasets/make_dataset.py:
``make_data_loader(cfg, is_train, is_distributed, max_iter)`` builds a
batch iterator from the config-selected Dataset, sampler (sequential /
shuffled / distributed, make_dataset.py:37-44), batch sampler (default /
image_size, 47-66), ``IterationBasedBatchSampler`` wrap when
``max_iter != -1`` (64-65) and a collator.

Difference: no worker processes / pin_memory — the loader is
a plain iterator of numpy batches (host RAM), and the training hot path
bypasses it entirely via the device-resident pipeline
(``datasets.pipeline``). Worker seeding (make_dataset.py:69-70,
time-based, non-deterministic) is replaced by deterministic seeds.
"""

from __future__ import annotations

from ..registry import resolve
from .collate import make_collator
from .samplers import (
    BatchSampler,
    DistributedSampler,
    ImageSizeBatchSampler,
    IterationBasedBatchSampler,
    RandomSampler,
    SequentialSampler,
)


def make_dataset(cfg, is_train: bool):
    ds_cfg = cfg.train_dataset if is_train else cfg.test_dataset
    module = cfg.train_dataset_module if is_train else cfg.test_dataset_module
    factory = resolve("dataset", module)
    return factory(cfg, **dict(ds_cfg))


def _make_sampler(dataset, shuffle: bool, is_distributed: bool,
                  num_replicas: int = 1, rank: int = 0):
    if is_distributed:
        return DistributedSampler(len(dataset), num_replicas, rank, shuffle=shuffle)
    if shuffle:
        return RandomSampler(len(dataset))
    return SequentialSampler(len(dataset))


def _make_batch_sampler(cfg, sampler, batch_size, drop_last, max_iter, is_train):
    kind = cfg.train.batch_sampler if is_train else cfg.test.batch_sampler
    meta = cfg.train.sampler_meta if is_train else cfg.test.sampler_meta
    if kind == "image_size":
        bs = ImageSizeBatchSampler(sampler, batch_size, drop_last, meta)
    else:
        bs = BatchSampler(sampler, batch_size, drop_last)
    if max_iter != -1:
        bs = IterationBasedBatchSampler(bs, max_iter)
    return bs


class DataLoader:
    """Minimal loader: batch sampler -> dataset.__getitem__ -> collate."""

    def __init__(self, dataset, batch_sampler, collate):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate = collate

    def __iter__(self):
        for batch_idx in self.batch_sampler:
            samples = []
            for item in batch_idx:
                if isinstance(item, tuple):  # image_size sampler: (idx, h, w)
                    samples.append(self.dataset[item[0]])
                else:
                    samples.append(self.dataset[item])
            yield self.collate(samples)

    def __len__(self):
        return len(self.batch_sampler)


def make_data_loader(cfg, is_train: bool = True, is_distributed: bool = False,
                     max_iter: int = -1, num_replicas: int = 1, rank: int = 0):
    dataset = make_dataset(cfg, is_train)
    if is_train:
        batch_size = cfg.train.batch_size
        shuffle = bool(cfg.train.shuffle)
        drop_last = False
    else:
        batch_size = cfg.test.batch_size
        shuffle = True if is_distributed else False
        drop_last = False
    sampler = _make_sampler(dataset, shuffle, is_distributed, num_replicas, rank)
    batch_sampler = _make_batch_sampler(
        cfg, sampler, batch_size, drop_last, max_iter, is_train)
    return DataLoader(dataset, batch_sampler, make_collator(cfg, is_train))
