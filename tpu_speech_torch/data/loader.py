"""Threaded prefetching data loader (host-side input pipeline).

The port's own copy of ``DataLoader`` of ``tpu_speech/data/loader.py:18``: a
thread pool and a bounded queue in place of worker processes (numpy FFT and
file reads release the GIL), and ``BucketedDataLoader`` (``:132-214``):
duration buckets, one static shape each.
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


class BucketedDataLoader(DataLoader):
    """Duration-bucketed batches: one static shape per bucket.

    The reference pads every CTC-finetune batch to the longest utterance in
    it (dynamic shapes, audio_to_text.py collate); a TPU-static single bucket
    instead pads everything to max_duration — LibriSpeech utterances average
    well under half of the 24 s cap, so that wastes ~2x compute. Bucketing
    recovers it TPU-natively: items are grouped into k duration buckets, each
    batch is drawn from ONE bucket and padded to that bucket's bound, and the
    step runs one shape per bucket (K1, K2 and K4 take each bucket's frame
    count as it comes).

    Multi-host safety: every process builds the SAME global batch schedule
    (same seed), then takes its shard's slice of each global batch, so the
    per-step shapes agree across processes (a shape mismatch would corrupt
    the global array assembly).

    run_length: emit batches in runs of this many consecutive same-bucket
    batches (= trainer.accumulate_grad_batches) so gradient-accumulation
    stacks never mix shapes. Per-bucket leftovers that can't fill a full run
    are dropped (< global_batch * run_length items per bucket per epoch).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_builder: Callable[[int], Callable],
        durations: Sequence[float],
        bucket_bounds: Sequence[float],
        sample_rate: int,
        run_length: int = 1,
        **kwargs,
    ):
        """collate_builder(bound_samples) -> collate_fn for one bucket;
        bucket_bounds: ascending per-bucket max durations (seconds), the last
        one >= every item's duration."""
        super().__init__(dataset, batch_size, None, **kwargs)
        self.durations = np.asarray(durations, dtype=np.float64)
        self.bounds = sorted(float(b) for b in bucket_bounds)
        self.sample_rate = sample_rate
        self.run_length = max(1, run_length)
        self.bucket_samples = [
            int(round(b * sample_rate)) for b in self.bounds
        ]
        self.collates = [collate_builder(s) for s in self.bucket_samples]
        self._bucket_of = np.searchsorted(
            np.asarray(self.bounds), self.durations, side="left"
        )
        self._bucket_of = np.minimum(self._bucket_of, len(self.bounds) - 1)

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        global_bs = self.batch_size * self.num_shards
        run_items = global_bs * self.run_length
        runs = []  # each: list of (bucket_id, global_idx_batch)
        for k in range(len(self.bounds)):
            idxs = order[self._bucket_of[order] == k]
            m = len(idxs) - len(idxs) % run_items
            for i in range(0, m, run_items):
                runs.append([
                    (k, idxs[j : j + global_bs])
                    for j in range(i, i + run_items, global_bs)
                ])
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 7919 + self._epoch)
            rng.shuffle(runs)
        lo = self.shard_id * self.batch_size
        hi = lo + self.batch_size
        return [
            (k, batch[lo:hi]) for run in runs for (k, batch) in run
        ]

    def _make_batch(self, spec):
        k, idxs = spec
        return self.collates[k]([self.dataset[int(i)] for i in idxs])

    def __len__(self):
        return len(self._batch_indices())
