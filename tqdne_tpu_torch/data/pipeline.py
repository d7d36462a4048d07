"""Host input pipeline: the port of ``BatchLoader`` and ``to_channels_last`` in
``tqdne_tpu/data/pipeline.py``.

A background thread reads and prepares the next batches (slab read, the
representation over the whole batch, the channels-last transpose) while the
device steps; each batch lands on one explicit device.  A loader failure is
re-raised in the training loop, not swallowed.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def to_channels_last(batch: dict) -> dict:
    """(B, C, *spatial) storage layout -> (B, *spatial, C) model layout."""
    out = dict(batch)
    for key in ("signal", "waveform", "cond_signal"):
        if key in out and out[key].ndim >= 3:
            out[key] = np.ascontiguousarray(np.moveaxis(out[key], 1, -1))
    return out


class BatchLoader:
    """Iterable over epochs of device batches (dicts of tensors).

    Shuffled with ``drop_last`` for training, in order for evaluation.  The
    shuffle of an epoch is seeded by ``seed + epoch``; ``epoch`` counts the
    iterations begun and may be set to resume in the middle of a run.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, device: str | torch.device = "cpu", prefetch: int = 2,
                 channels_last: bool = True, keys: tuple[str, ...] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.device = torch.device(device)
        self.prefetch = prefetch
        self.channels_last = channels_last
        self.keys = keys
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> list[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        end = n - (n % self.batch_size) if self.drop_last else n
        return [idx[s : s + self.batch_size] for s in range(0, end, self.batch_size)]

    def _prepare(self, batch_idx: np.ndarray) -> dict:
        batch = self.dataset.load_batch(batch_idx, keys=self.keys)
        if self.keys is not None:
            batch = {k: v for k, v in batch.items() if k in self.keys}
        if self.channels_last:
            batch = to_channels_last(batch)
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        self.epoch += 1
        if self.prefetch <= 0:
            for b in batches:
                yield self._prepare(b)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        halt = threading.Event()  # the consumer left early (max_steps): stop reading

        def producer():
            try:
                for b in batches:
                    if halt.is_set():
                        return
                    q.put(self._prepare(b))
                q.put(stop)
            except BaseException as e:  # noqa: BLE001 - relayed to the consumer, re-raised there
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            halt.set()
            while thread.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()
