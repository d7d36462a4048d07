"""Training loop: the port of ``Trainer`` and ``MetricWriter`` in
``tqdne_tpu/train/loop.py``.

One process drives one device.  Validation runs the EMA module; checkpoints
keep the best 3 by validation loss plus the last, with the epoch in
``progress.json``, so a resume is exact; metrics stream to ``metrics.jsonl``
with the JAX package's keys (``training/loss``, ``traintime``, ``lr``,
``validation/loss``).  Validation means may be vectors (per-class counts)
that ``metric_postprocess`` turns into the scalars written.

Randomness is per step, as the JAX loop folds the step into its root key:
step ``n`` seeds the step's ``torch.Generator`` (the encoder's eps, the
sigma normal and the diffusion noise) and the device's default generator
(dropout) from ``(seed, n)``, and validation batch ``i`` from
``(seed, 2**31 + i)``.  A resumed run therefore draws what an uninterrupted
one would.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from tqdne_tpu_torch.train.checkpoint import Checkpointer


def step_seed(seed: int, n: int, stream: int) -> int:
    """A 63-bit seed for draw ``stream`` of step ``n``."""
    return int(np.random.SeedSequence([seed, n, stream]).generate_state(1, np.uint64)[0] >> 1)


class MetricWriter:
    """JSONL metric sink: one ``{"step": n, ...}`` row per write."""

    def __init__(self, workdir: str | Path):
        self.path = Path(workdir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a")

    def write(self, step: int, metrics: dict):
        record = {"step": int(step), **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class Trainer:
    """Epoch-based training loop over ``train_step``/``eval_step`` from
    the factories of ``train.steps``.

    ``metric_postprocess``: applied to the epoch's validation means before
    they are written, e.g. per-class confusion counts into macro precision,
    recall and F1, which are only right after aggregation."""

    def __init__(self, train_step: Callable, eval_step: Callable, workdir: str | Path, *,
                 device: str | torch.device = "cuda", max_epochs: int = 100,
                 max_steps: int | None = None, log_every: int = 50, eval_every_epochs: int = 1,
                 checkpoint_every_epochs: int = 1, seed: int = 0,
                 lr_schedule: Callable | None = None, hparams: dict | None = None,
                 metric_postprocess: Callable[[dict], dict] | None = None):
        self.train_step = train_step
        self.eval_step = eval_step
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.device = torch.device(device)
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.log_every = log_every
        self.eval_every_epochs = eval_every_epochs
        self.checkpoint_every_epochs = checkpoint_every_epochs
        self.seed = seed
        self.lr_schedule = lr_schedule
        self.hparams = hparams
        self.metric_postprocess = metric_postprocess
        self.writer = MetricWriter(self.workdir)
        self.checkpointer = Checkpointer(self.workdir / "checkpoints")
        self.generator = torch.Generator(device=self.device)
        self._last_heartbeat = 0.0

    def _seed_step(self, n: int):
        self.generator.manual_seed(step_seed(self.seed, n, 0))
        torch.manual_seed(step_seed(self.seed, n, 1))  # dropout: the default generators

    def _write_progress(self, epoch: int, step: int):
        (self.workdir / "checkpoints" / "progress.json").write_text(
            json.dumps({"epoch": int(epoch), "step": int(step)}))

    def _read_progress(self) -> dict | None:
        p = self.workdir / "checkpoints" / "progress.json"
        return json.loads(p.read_text()) if p.exists() else None

    def _save(self, step: int, state, epochs_done: int, metrics=None):
        self.checkpointer.save(step, state, metrics=metrics)
        self._write_progress(epochs_done, step)

    def fit(self, state, train_loader, val_loader=None, *, resume: bool = True):
        """Run the loop on ``state`` (updated in place; also returned)."""
        if self.hparams is not None:
            matched = resume and self.checkpointer.verify_hyperparameters(self.hparams)
            if not matched:  # a fresh run: the new architecture wins
                self.checkpointer.save_hyperparameters(self.hparams)

        start_epoch = 0
        if resume:
            ckpt_step = self.checkpointer.restore_latest(state)
            if ckpt_step is not None:
                progress = self._read_progress()
                if progress is not None and progress.get("step") == ckpt_step:
                    start_epoch = progress["epoch"]
                else:  # no progress record of this step
                    start_epoch = ckpt_step // max(len(train_loader), 1)

        gstep = state.step
        saved_at = None
        t_train = 0.0
        hit_max = False
        epochs_done = start_epoch
        for epoch in range(start_epoch, self.max_epochs):
            train_loader.epoch = epoch  # the epoch's shuffle, on a resume too
            pending: list[tuple[int, dict]] = []
            done_in_epoch = 0
            for batch in train_loader:
                t0 = time.perf_counter()
                self._seed_step(gstep)
                metrics = self.train_step(state, batch, generator=self.generator)
                pending.append((gstep, metrics))
                gstep += 1
                done_in_epoch += 1
                if gstep % self.log_every == 0:
                    float(metrics["loss"])  # one device sync per log window
                    t_train += time.perf_counter() - t0
                    self._log(pending, t_train)
                    pending.clear()
                else:
                    t_train += time.perf_counter() - t0
                if self.max_steps is not None and gstep >= self.max_steps:
                    hit_max = True
                    break

            # an epoch cut short by max_steps is replayed from its start on a resume
            epochs_done = epoch + 1 if done_in_epoch == len(train_loader) else epoch
            if pending:  # flush the epoch's tail so short epochs still log
                self._log(pending, t_train)
                pending.clear()

            now = time.monotonic()
            if now - self._last_heartbeat >= 60.0:
                self._last_heartbeat = now
                print(f"[train] epoch {epoch + 1}/{self.max_epochs} step {gstep}", flush=True)

            val_metrics = {}
            if val_loader is not None and (epoch + 1) % self.eval_every_epochs == 0:
                val_metrics = self.validate(state, val_loader, gstep)

            if (epoch + 1) % self.checkpoint_every_epochs == 0 or hit_max:
                self._save(gstep, state, epochs_done, val_metrics or None)
                saved_at = gstep
            if hit_max:
                break

        if saved_at != gstep:
            self._save(gstep, state, epochs_done)
        return state

    def _log(self, pending, traintime: float):
        step, metrics = pending[-1]
        host = {f"training/{k}": float(v) for k, v in metrics.items()}
        host["traintime"] = traintime
        if self.lr_schedule is not None:
            host["lr"] = float(self.lr_schedule(step))
        self.writer.write(step, host)

    def validate(self, state, val_loader, gstep: int) -> dict:
        sums: dict = {}
        n = 0
        for batch in val_loader:
            self.generator.manual_seed(step_seed(self.seed, 2**31 + n, 0))
            for k, v in self.eval_step(state, batch, generator=self.generator).items():
                sums[k] = sums.get(k, 0.0) + v.detach().cpu().double().numpy()
            n += 1
        means = {k: v / max(n, 1) for k, v in sums.items()}
        if self.metric_postprocess is not None:
            means = self.metric_postprocess(means)
        means = {k: float(v) for k, v in means.items()}
        self.writer.write(gstep, {f"validation/{k}": v for k, v in means.items()})
        return means
