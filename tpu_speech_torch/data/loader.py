"""Threaded prefetching data loader (host-side input pipeline).

The port's own copy of ``DataLoader`` of ``tpu_speech/data/loader.py:18``: a
thread pool and a bounded queue in place of worker processes (numpy FFT and
file reads release the GIL). ``BucketedDataLoader`` comes with the slice that
needs it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        batch_fn: Callable = None,
    ):
        """shard_id/num_shards: multi-process data sharding — every process
        shuffles with the same seed (consistent global order) then takes a
        strided subset, as DistributedSampler does.

        batch_fn: optional whole-batch builder `idxs -> batch dict` that
        replaces the per-item dataset fetch + collate."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)
        self.batch_fn = batch_fn
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The next iteration shuffles as epoch ``epoch + 1`` does (a
        resumed run continues the straight run's order)."""
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> Sequence[Sequence[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        if self.num_shards > 1:
            # every shard must yield the SAME number of items: each batch
            # drives a collective step over the global mesh, so a process
            # with one extra batch would launch a step its peers never join
            # (multi-controller hang). Truncate to the common shard length
            # (DistributedSampler pads instead; truncation keeps batches
            # duplicate-free and loses < num_shards items per epoch).
            order = order[self.shard_id :: self.num_shards]
            order = order[: n // self.num_shards]
            n = len(order)
        batches = []
        for i in range(0, n - self.batch_size + 1, self.batch_size):
            batches.append(order[i : i + self.batch_size])
        if not self.drop_last and n % self.batch_size:
            batches.append(order[n - n % self.batch_size :])
        return batches

    def _make_batch(self, idxs):
        if self.batch_fn is not None:
            return self.batch_fn(idxs)
        return self.collate_fn([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator:
        self._epoch += 1
        batches = self._batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        make_batch = self._make_batch

        def producer():
            window = self.num_workers + self.prefetch
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                from collections import deque

                pending = deque()
                it = iter(batches)
                try:
                    while True:
                        while len(pending) < window:
                            try:
                                pending.append(pool.submit(make_batch, next(it)))
                            except StopIteration:
                                break
                        if not pending:
                            break
                        if stop.is_set():
                            for f in pending:
                                f.cancel()
                            return
                        q.put(pending.popleft().result())
                except Exception as e:  # surface worker errors to the consumer
                    q.put(e)
                    return
            q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
