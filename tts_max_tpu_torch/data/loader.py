"""Deterministic multi-host data loader with prefetch and exact resume.

Copy of ``tts_max_tpu/data/loader.py`` (the port imports nothing of the JAX package).

Replaces torch DataLoader (reference tts_datasets.py:268-283):

- deterministic per-epoch shuffle from a seed (identical on every process);
- per-process batch sharding: process p takes batch rows [p*B_local, ...) of
  the global batch, so the global batch order is host-count invariant;
- background prefetch thread (the 2-CPU host overlaps tokenization with TPU
  steps);
- ``skip_batches`` fast-forward resume: the dataset's fast-forward mode makes
  skipped batches free (reference training_loop.py:56-71).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable[[list], dict[str, Any]],
        shuffle: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch {batch_size} must divide by {process_count} processes"
            )
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // process_count
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset) // self.global_batch
        if not self.drop_last and len(self.dataset) % self.global_batch:
            n += 1
        return n

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        return order

    def batches(self, epoch: int = 0, skip_batches: int = 0) -> Iterator[dict]:
        """Yield collated local batches for this process."""
        order = self._epoch_order(epoch)
        n_batches = len(self)
        if skip_batches and hasattr(self.dataset, "enable_fast_forwarding"):
            self.dataset.enable_fast_forwarding()

        def produce(q: queue.Queue):
            try:
                for b in range(n_batches):
                    if b == skip_batches and hasattr(
                        self.dataset, "disable_fast_forwarding"
                    ):
                        self.dataset.disable_fast_forwarding()
                    lo = b * self.global_batch + self.process_index * self.local_batch
                    idxs = order[lo : lo + self.local_batch]
                    items = [self.dataset[int(i)] for i in idxs]
                    q.put(self.collate_fn(items))
                q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __iter__(self):
        return self.batches(0)
