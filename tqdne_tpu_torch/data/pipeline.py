"""Input pipeline: the port of ``BatchLoader``, ``DeviceResidentLoader`` and
``to_channels_last`` in ``tqdne_tpu/data/pipeline.py``.

``BatchLoader``: a background thread reads and prepares the next batches
(slab read, the representation over the whole batch, the channels-last
transpose) while the device steps; each batch lands on one explicit device.
A loader failure is re-raised in the training loop, not swallowed.

``DeviceResidentLoader``: the requested columns go to the device once and
each batch is a gather there by an index tensor, so the host loader leaves
the step's critical path (cached-latent training, whose columns are small).
Both shuffle an epoch with ``default_rng(seed + epoch)``, so they give the
same batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from tqdne_tpu_torch.utils import resolve_device


def to_channels_last(batch: dict) -> dict:
    """(B, C, *spatial) storage layout -> (B, *spatial, C) model layout."""
    out = dict(batch)
    for key in ("signal", "waveform", "cond_signal"):
        if key in out and out[key].ndim >= 3:
            out[key] = np.ascontiguousarray(np.moveaxis(out[key], 1, -1))
    return out


def _epoch_batches(n: int, batch_size: int, shuffle: bool, drop_last: bool,
                   seed: int) -> list[np.ndarray]:
    """One epoch's row indices per batch, shuffled by ``default_rng(seed)``."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    end = n - (n % batch_size) if drop_last else n
    return [idx[s : s + batch_size] for s in range(0, end, batch_size)]


class BatchLoader:
    """Iterable over epochs of device batches (dicts of tensors), on the card unless
    ``device`` says otherwise.

    Shuffled with ``drop_last`` for training, in order for evaluation.  The
    shuffle of an epoch is seeded by ``seed + epoch``; ``epoch`` counts the
    iterations begun and may be set to resume in the middle of a run.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, device: str | torch.device = "cuda", prefetch: int = 2,
                 channels_last: bool = True, keys: tuple[str, ...] | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.channels_last = channels_last
        self.keys = keys
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> list[np.ndarray]:
        return _epoch_batches(len(self.dataset), self.batch_size, self.shuffle, self.drop_last,
                              self.seed + self.epoch)

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


class DeviceResidentLoader:
    """Epoch iterable whose batches are gathers on the device from a copy of
    the requested dataset columns made once, at construction; shuffled with
    ``drop_last``, as ``BatchLoader`` trains.

    For small training sets (the flagship's cached latent moments): a step
    then moves one index tensor to the device instead of a batch.  The
    caller decides with ``fits()`` and keeps ``BatchLoader`` otherwise.
    """

    def __init__(self, dataset, batch_size: int, *, keys: tuple[str, ...], seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.epoch = 0
        host = dataset.load_batch(np.arange(len(dataset)), keys=keys)
        host = to_channels_last({k: v for k, v in host.items() if k in keys})
        self._resident = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    @staticmethod
    def fits(dataset, keys: tuple[str, ...], budget_bytes: int = 2 << 30) -> bool:
        """Whether the requested columns fit the device-resident budget,
        estimated from one row."""
        row = dataset.load_batch(np.arange(1), keys=keys)
        return sum(v.nbytes for k, v in row.items() if k in keys) * len(dataset) <= budget_bytes

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        batches = _epoch_batches(len(self.dataset), self.batch_size, True, True,
                                 self.seed + self.epoch)
        self.epoch += 1
        for batch_idx in batches:
            idx = torch.from_numpy(batch_idx).to(self.device)
            yield {k: v.index_select(0, idx) for k, v in self._resident.items()}
