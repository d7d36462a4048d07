"""Training loop: the port of ``Trainer`` and ``MetricWriter`` in
``tqdne_tpu/train/loop.py``.

One process drives one device; under a process group each rank trains on
its rows of every global batch (``data.pipeline``), ``apply_updates``
averages the gradients, and rank 0 alone writes ``metrics.jsonl``, the
heartbeat, ``hparams.json``, the checkpoints and ``progress.json``, every
rank waiting at a barrier after each write; on a resume every rank restores
from the shared directory.  The logged training metrics and the validation
means are averaged over the ranks first.  Validation runs the EMA module; checkpoints
keep the best 3 by validation loss plus the last, with the epoch in
``progress.json``, so a resume is exact; metrics stream to ``metrics.jsonl``
with the JAX package's keys (``training/loss``, ``traintime``, ``lr``,
``validation/loss``).  Validation means may be vectors (per-class counts)
that ``metric_postprocess`` turns into the scalars written.  Each of
``callbacks`` is called ``cb(trainer, state, epoch, gstep)`` at the end of
every epoch, after validation and before the checkpoint (the sampling-eval
callback of ``train.callbacks``).

Randomness is per step, as the JAX loop folds the step into its root key:
step ``n`` seeds the step's ``torch.Generator`` (the encoder's eps, the
sigma normal and the diffusion noise) from ``(seed, n)`` on every rank, and
the device's default generator (dropout) from ``(seed, n)`` and the rank
(rank 0 as a single process), and validation batch ``i`` from
``(seed, 2**31 + i)``.  A resumed run therefore draws what an uninterrupted
one would, and an N-rank run at dropout 0 what the 1-rank run at the same
global batch does (the JAX package draws one dropout mask for the global
batch; here each rank draws its own).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from tqdne_tpu_torch.parallel import all_reduce_sum, barrier, rank, world_size
from tqdne_tpu_torch.train.checkpoint import Checkpointer
from tqdne_tpu_torch.utils.tracing import span


def step_seed(seed: int, n: int, stream: int, rank: int = 0) -> int:
    """A 63-bit seed for draw ``stream`` of step ``n`` on ``rank``."""
    entropy = [seed, n, stream] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def mean_over_ranks(values: dict) -> dict:
    """``{k: array}`` averaged over the world in one collective (float64 on
    the host); the values as they are at world size 1."""
    n = world_size()
    if n == 1 or not values:
        return values
    arrays = {k: np.atleast_1d(np.asarray(v, np.float64)) for k, v in values.items()}
    flat = all_reduce_sum(torch.from_numpy(np.concatenate(list(arrays.values())))) / n
    out, offset = {}, 0
    for k, a in arrays.items():
        out[k] = flat[offset:offset + a.size].numpy().reshape(np.shape(values[k]))
        offset += a.size
    return out


class MetricWriter:
    """JSONL metric sink: one ``{"step": n, ...}`` row per write, on rank 0
    only (one metrics stream per run)."""

    def __init__(self, workdir: str | Path):
        self.path = Path(workdir) / "metrics.jsonl"
        self._file = None
        if rank() == 0:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.path, "a")

    def write(self, step: int, metrics: dict):
        if self._file is None:
            return
        record = {"step": int(step), **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()


class Trainer:
    """Epoch-based training loop over ``train_step``/``eval_step`` from
    the factories of ``train.steps``.

    ``metric_postprocess``: applied to the epoch's validation means before
    they are written, e.g. per-class confusion counts into macro precision,
    recall and F1, which are only right after aggregation.  ``callbacks``:
    called ``cb(trainer, state, epoch, gstep)`` after each epoch's
    validation, before its checkpoint.

    ``profile_steps=(start, stop)``: steps ``start`` to ``stop - 1`` run under
    ``torch.profiler`` (the CPU and, on a card, CUDA activity), and rank 0
    writes the chrome trace to ``workdir/profile/steps_<start>_<stop>.json``,
    as the JAX ``Trainer`` writes its trace.  Besides the kernels it holds the
    port's spans (``utils.tracing``): ``tq::fit.load`` (the loader's
    ``next``), ``tq::fit.step`` (the step call), ``tq::fit.log`` (the logging
    sync), and inside the step ``tq::loss``, ``tq::backward`` and
    ``tq::update``, down to ``tq::conv``, ``tq::norm`` and the kernels' own."""

    def __init__(self, train_step: Callable, eval_step: Callable, workdir: str | Path, *,
                 device: str | torch.device = "cuda", max_epochs: int = 100,
                 max_steps: int | None = None, log_every: int = 50, eval_every_epochs: int = 1,
                 checkpoint_every_epochs: int = 1, seed: int = 0,
                 lr_schedule: Callable | None = None, hparams: dict | None = None,
                 metric_postprocess: Callable[[dict], dict] | None = None,
                 callbacks: Sequence[Callable] = (),
                 profile_steps: tuple[int, int] | None = None):
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
        self.callbacks = list(callbacks)
        self.profile_steps = profile_steps
        self._profiler = None
        self.writer = MetricWriter(self.workdir)
        self.checkpointer = Checkpointer(self.workdir / "checkpoints")
        self.generator = torch.Generator(device=self.device)
        self._last_heartbeat = 0.0

    def _profile(self, gstep: int):
        """Called before each step's load and after each step (``gstep`` the
        next step): start the profiler before step ``start``, stop it once step
        ``stop - 1`` is done (rank 0 only).  A window the fit cuts short ends
        with the fit."""
        if self.profile_steps is None or rank() != 0:
            return
        start, stop = self.profile_steps
        if gstep == start and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif gstep >= stop and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
            out = self.workdir / "profile" / f"steps_{start}_{stop}.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            self._profiler.export_chrome_trace(str(out))
            self._profiler = None
            print(f"[train] profiler trace written to {out}", flush=True)

    def _seed_step(self, n: int):
        self.generator.manual_seed(step_seed(self.seed, n, 0))
        # dropout: the default generators, each rank's own
        torch.manual_seed(step_seed(self.seed, n, 1, rank()))

    def _write_progress(self, epoch: int, step: int):
        (self.workdir / "checkpoints" / "progress.json").write_text(
            json.dumps({"epoch": int(epoch), "step": int(step)}))

    def _read_progress(self) -> dict | None:
        p = self.workdir / "checkpoints" / "progress.json"
        return json.loads(p.read_text()) if p.exists() else None

    def _save(self, step: int, state, epochs_done: int, metrics=None):
        if rank() == 0:
            self.checkpointer.save(step, state, metrics=metrics)
            self._write_progress(epochs_done, step)
        barrier()

    def fit(self, state, train_loader, val_loader=None, *, resume: bool = True):
        """Run the loop on ``state`` (updated in place; also returned)."""
        if self.hparams is not None:
            matched = resume and self.checkpointer.verify_hyperparameters(self.hparams)
            if not matched and rank() == 0:  # a fresh run: the new architecture wins
                self.checkpointer.save_hyperparameters(self.hparams)
            barrier()

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
            batches = iter(train_loader)
            while True:
                self._profile(gstep)
                with span("fit.load"):
                    batch = next(batches, None)
                if batch is None:
                    break
                t0 = time.perf_counter()
                self._seed_step(gstep)
                with span("fit.step"):
                    metrics = self.train_step(state, batch, generator=self.generator)
                pending.append((gstep, metrics))
                gstep += 1
                done_in_epoch += 1
                if gstep % self.log_every == 0:
                    with span("fit.log"):
                        float(metrics["loss"])  # one device sync per log window
                        t_train += time.perf_counter() - t0
                        self._log(pending, t_train)
                    pending.clear()
                else:
                    t_train += time.perf_counter() - t0
                self._profile(gstep)
                if self.max_steps is not None and gstep >= self.max_steps:
                    hit_max = True
                    break

            # an epoch cut short by max_steps is replayed from its start on a resume
            epochs_done = epoch + 1 if done_in_epoch == len(train_loader) else epoch
            if pending:  # flush the epoch's tail so short epochs still log
                self._log(pending, t_train)
                pending.clear()

            now = time.monotonic()
            if rank() == 0 and now - self._last_heartbeat >= 60.0:
                self._last_heartbeat = now
                print(f"[train] epoch {epoch + 1}/{self.max_epochs} step {gstep}", flush=True)

            val_metrics = {}
            if val_loader is not None and (epoch + 1) % self.eval_every_epochs == 0:
                val_metrics = self.validate(state, val_loader, gstep)

            for cb in self.callbacks:
                cb(self, state, epoch, gstep)

            if (epoch + 1) % self.checkpoint_every_epochs == 0 or hit_max:
                self._save(gstep, state, epochs_done, val_metrics or None)
                saved_at = gstep
            if hit_max:
                break

        if self._profiler is not None:  # a window the fit cut short
            self._profile(self.profile_steps[1])
        if saved_at != gstep:
            self._save(gstep, state, epochs_done)
        return state

    def _log(self, pending, traintime: float):
        step, metrics = pending[-1]
        means = mean_over_ranks({k: v.detach().double().cpu().numpy() for k, v in metrics.items()})
        host = {f"training/{k}": float(v) for k, v in means.items()}
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
        means = mean_over_ranks({k: v / max(n, 1) for k, v in sums.items()})
        if self.metric_postprocess is not None:
            means = self.metric_postprocess(means)
        means = {k: float(v) for k, v in means.items()}
        self.writer.write(gstep, {f"validation/{k}": v for k, v in means.items()})
        return means
