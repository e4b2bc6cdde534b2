"""Host-side batching: the epoch-seeded shuffle, the per-host shard, thread prefetch.

The port's own copy of :mod:`pcdiff.data.loader` (numpy): each host walks its contiguous
shard of one permutation seeded by the epoch, batches are stacked numpy dicts, and a
background thread keeps ``prefetch`` batches ready while the card computes.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

__all__ = ["BatchLoader"]


class BatchLoader:
    """Iterate stacked-dict batches from a map-style dataset.

    dataset must implement ``__len__`` and ``__getitem__(idx, rng=...)``
    returning a dict of numpy arrays.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the global shuffle (DistributedSampler.set_epoch parity)."""
        self.epoch = epoch

    def __len__(self) -> int:
        per_host = len(self.dataset) // self.process_count
        if self.drop_last:
            return per_host // self.batch_size
        return -(-per_host // self.batch_size)

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        # contiguous per-host shard of the shared permutation
        per_host = n // self.process_count
        start = self.process_index * per_host
        return order[start : start + per_host]

    def epoch_indices(self) -> np.ndarray:
        """This epoch's batch index table ``[n_batches, batch_size]``: the same shard
        of the same epoch-seeded permutation that the iterator walks. The device-resident
        data path (``cli.train``) sends only these rows to the card. Requires
        ``drop_last``."""
        if not self.drop_last:
            raise ValueError("epoch_indices requires drop_last=True")
        order = self._index_order()
        nb = len(order) // self.batch_size
        return order[: nb * self.batch_size].reshape(
            nb, self.batch_size).astype(np.int32)

    def _make_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(
            (self.seed + 1) * 100_003 + self.epoch * 1_009 + self.process_index
        )
        order = self._index_order()
        nb = len(order) // self.batch_size if self.drop_last else -(-len(order) // self.batch_size)
        for b in range(nb):
            idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
            items = [self.dataset.__getitem__(int(i), rng=rng) for i in idxs]
            yield {
                k: np.stack([it[k] for it in items], axis=0) for k in items[0]
            }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._make_batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for batch in self._make_batches():
                    q.put(batch)
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]
