"""Training callbacks: the port of ``tqdne_tpu/train/callbacks.py``.

``SamplingEvalCallback``: every N epochs it samples a few validation
batches with the EMA model, inverts the representation to waveforms on the
device, evaluates a metric list on the (predicted, target) waveforms, writes
the scalars as ``eval/<metric>`` and the figures under
``workdir/plots/epoch_{e}/``.  Non-finite predictions are warned about and
zeroed.  This module imports no matplotlib (the plots given to it do).

Under a process group each rank holds its rows of the validation batches
and samples them (the per-row draws are its rows of the global batch's, as
in training); the predictions, targets and conditioning are gathered in rank
order, so every rank evaluates the metrics on the whole of each batch, and
rank 0 alone writes the scalars and the figures.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from tqdne_tpu_torch.data.representation import invert
from tqdne_tpu_torch.parallel import all_gather_rows, rank
from tqdne_tpu_torch.utils import fold_seed

logger = logging.getLogger("tqdne_tpu_torch")


class SamplingEvalCallback:
    """Callable as ``cb(trainer, state, epoch, gstep)`` (``Trainer(callbacks=)``).

    Parameters
    ----------
    sample_fn:
        ``(model, generator, batch) -> channels-last signal samples`` (B, *S, C)
        on the trainer's device, for the batch's conditioning; it is given the
        EMA module and a ``torch.Generator`` on the trainer's device seeded
        ``utils.fold_seed(seed, epoch * 1000 + i)`` for validation batch ``i``.
    val_batches:
        Batches held on the host: dicts with the channels-last ``waveform``
        targets (B, T, C) and, for a conditional model, ``cond``.
    representation:
        Inverts the signals to waveforms on their device (Griffin-Lim draws its
        initial phase from the batch's generator).
    metrics / plots:
        ``eval.metrics.Metric`` / ``eval.plots.Plot`` instances over
        channel-first waveform batches (numpy).
    feature_stats / features_keys:
        (F, 2) [mean, std] of each conditioning feature and the features'
        names.  When given, ``cond`` is denormalised and the raw magnitude and
        hypocentral distance go to every plot as ``mag=`` and ``dist=``, for
        the Bin and Grid figures.
    max_consecutive_failures:
        A metric or plot that fails this many evaluations in a row raises;
        fewer failures are warnings.
    """

    def __init__(self, sample_fn: Callable, val_batches: Sequence[dict], representation,
                 metrics: Sequence = (), plots: Sequence = (), every_n_epochs: int = 10,
                 seed: int = 123, feature_stats=None, features_keys: Sequence[str] = (),
                 max_consecutive_failures: int = 3):
        self.sample_fn = sample_fn
        self.val_batches = list(val_batches)
        self.representation = representation
        self.metrics = list(metrics)
        self.plots = list(plots)
        self.every_n_epochs = every_n_epochs
        self.seed = seed
        self.feature_stats = None if feature_stats is None else np.asarray(feature_stats)
        self.features_keys = list(features_keys)
        self.max_consecutive_failures = max_consecutive_failures
        self._failures: dict[str, int] = {}

    def _record_failure(self, kind: str, name: str, err: Exception):
        count = self._failures.get(name, 0) + 1
        self._failures[name] = count
        logger.warning("%s %s failed (%d consecutive): %s", kind, name, count, err)
        if count >= self.max_consecutive_failures:
            raise RuntimeError(
                f"{kind} {name!r} failed {count} sampling evals in a row (last error: {err}); "
                "fix it or drop it from the callback") from err

    @torch.no_grad()
    def __call__(self, trainer, state, epoch: int, gstep: int):
        if (epoch + 1) % self.every_n_epochs != 0:
            return
        preds, targets, conds = [], [], []
        for i, batch in enumerate(self.val_batches):
            generator = torch.Generator(device=trainer.device).manual_seed(
                fold_seed(self.seed, epoch * 1000 + i))
            pred_signal = self.sample_fn(state.ema, generator, batch)
            if not bool(torch.isfinite(pred_signal).all()):
                logger.warning("prediction contains non-finite values; zeroing (NaN guard)")
                pred_signal = torch.nan_to_num(pred_signal)
            pred_wf = invert(self.representation, pred_signal.movedim(-1, 1), generator=generator)
            target_wf = torch.as_tensor(batch["waveform"]).movedim(-1, 1)
            if len(pred_wf) != len(target_wf):
                raise ValueError(
                    f"sampling eval batch {i}: {len(pred_wf)} predictions vs {len(target_wf)} "
                    "targets — sample_fn must preserve batch size")
            preds.append(all_gather_rows(pred_wf).cpu().numpy())
            targets.append(all_gather_rows(target_wf).cpu().numpy())
            if "cond" in batch:
                conds.append(all_gather_rows(torch.as_tensor(batch["cond"])).cpu().numpy())

        pred = np.concatenate(preds)
        target = np.concatenate(targets)[:, :, : pred.shape[-1]]

        plot_kwargs = {}
        if conds and self.feature_stats is not None and self.features_keys:
            raw = np.concatenate(conds) * self.feature_stats[:, 1] + self.feature_stats[:, 0]
            by_key = dict(zip(self.features_keys, raw.T))
            if "magnitude" in by_key:
                plot_kwargs["mag"] = by_key["magnitude"]
            if "hypocentral_distance" in by_key:
                plot_kwargs["dist"] = by_key["hypocentral_distance"]

        scalars = {}
        for metric in self.metrics:
            try:
                scalars[f"eval/{metric.name}"] = float(metric(pred, target))
                self._failures.pop(metric.name, None)
            except Exception as e:  # noqa: BLE001 - counted; raised after repeated failures
                self._record_failure("metric", metric.name, e)
        if scalars:
            trainer.writer.write(gstep, scalars)

        if self.plots and rank() == 0:
            plotdir = Path(trainer.workdir) / "plots" / f"epoch_{epoch}"
            plotdir.mkdir(parents=True, exist_ok=True)
            for plot in self.plots:
                try:
                    fig = plot(pred, target, **plot_kwargs)
                    fig.savefig(plotdir / f"{plot.name.replace(' ', '_')}.png", dpi=100)
                    self._failures.pop(plot.name, None)
                except Exception as e:  # noqa: BLE001 - counted; raised after repeated failures
                    self._record_failure("plot", plot.name, e)
