"""The train and validation loaders of a dataset config: the port of
``tqdne_tpu/data/dataloader.py``.  The train loader shuffles and drops the
last partial batch; the validation loader reads in order (and also drops
it, as the JAX one does)."""

from __future__ import annotations

from tqdne_tpu_torch.data.dataset import Dataset
from tqdne_tpu_torch.data.pipeline import BatchLoader


def get_train_and_val_loader(config, batch_size: int, *, cond: bool = False, mesh=None,
                             val_batch_size: int | None = None,
                             keys: tuple[str, ...] | None = None, prefetch: int = 2,
                             device="cuda") -> tuple[BatchLoader, BatchLoader]:
    """(train, validation) ``BatchLoader``s over ``config.datapath``'s
    ``train`` and ``validation`` splits, cut to ``config.t`` samples, each
    batch on ``device``.  ``mesh`` is the JAX data-parallel sharding, which
    the port does not have: anything but None is refused."""
    if mesh is not None:
        raise ValueError("get_train_and_val_loader: a device mesh (data-parallel sharding) is "
                         "not supported; pass mesh=None")
    representation = config.make_representation()

    def loader(split, size, shuffle):
        dataset = Dataset(config.datapath, representation, cut=config.t, cond=cond, split=split)
        return BatchLoader(dataset, size, shuffle=shuffle, drop_last=True, prefetch=prefetch,
                           keys=keys, device=device)

    return (loader("train", batch_size, True),
            loader("validation", val_batch_size or batch_size, False))
