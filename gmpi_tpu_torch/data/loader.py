"""Sharded, prefetching batch loader (port of ``gmpi_tpu/data/loader.py``).

Replaces the reference's torch ``DataLoader + DistributedSampler``
(``gmpi/datasets.py:380-400``) with the JAX package's design, so that both
packages yield the same batches in the same order for the same dataset and
seed (``torch.utils.data.DataLoader``'s sampler orders differently):

* deterministic per-epoch shuffling (``np.random.Generator(PCG64(seed +
  epoch))`` — the ``set_epoch`` analogue, ``gmpi/train.py:408``);
* sharding by (shard_id, num_shards), padded so every shard sees the same
  count, with drop-last batches;
* a thread pool keeping ``prefetch`` batches in flight, so image decode
  overlaps the device's step.

Batches are tuples of stacked numpy fields; the training loop moves them to
the card.  A batch not ready when the consumer asks for it is waited for in
a ``loader.wait`` span of ``torch.profiler`` (``utils.inspect.profile_scope``).
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np

from gmpi_tpu_torch.utils.inspect import profile_scope


class ShardedLoader:
    def __init__(self, dataset, batch_size: int, shard_id: int = 0, num_shards: int = 1,
                 seed: int = 0, shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 4, prefetch: int = 2):
        if batch_size < 1 or not 0 <= shard_id < num_shards:
            raise ValueError(f"batch_size {batch_size}, shard {shard_id} of {num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.Generator(np.random.PCG64(self.seed + epoch)).shuffle(idx)
        # pad so every shard sees the same count (DistributedSampler semantics)
        per_shard = -(-n // self.num_shards)
        padded = np.concatenate([idx, idx[: per_shard * self.num_shards - n]])
        return padded[self.shard_id:: self.num_shards]

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield batches of stacked sample fields for one epoch."""
        idx = self._epoch_indices(epoch)
        n_batches = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            n_batches += 1

        def fetch(i: int):
            lo = i * self.batch_size
            items = [self.dataset[int(j)] for j in idx[lo: lo + self.batch_size]]
            return tuple(np.stack([it[f] for it in items]) for f in range(len(items[0])))

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = queue.Queue()
            submitted = 0
            for _ in range(min(self.prefetch, n_batches)):
                futures.put(pool.submit(fetch, submitted))
                submitted += 1
            for _ in range(n_batches):
                future = futures.get()
                if future.done():
                    batch = future.result()
                else:  # the consumer starves: a span as long as the wait
                    with profile_scope("loader.wait"):
                        batch = future.result()
                if submitted < n_batches:
                    futures.put(pool.submit(fetch, submitted))
                    submitted += 1
                yield batch

    def __iter__(self):
        """Infinite stream over epochs 0, 1, 2, ..."""
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1
