"""Checkpoints: the port of ``tqdne_tpu/train/checkpoint.py`` with
``torch.save`` in place of orbax.

Two directories under the run's ``checkpoints/``: ``last/`` keeps the newest
save, ``best/`` the best ``max_best`` by the monitored validation metric
(lowest first), with their metrics in ``best/index.json``.  A save holds the
whole train state (step, live and EMA parameters, optimizer state), so a
resume is exact.  ``hparams.json`` beside them makes a run self-describing:
a resume checks the requested architecture against it.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

import torch

logger = logging.getLogger("tqdne_tpu_torch")


def _atomic_save(obj, path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: Path) -> list[int]:
    return sorted(int(p.stem) for p in directory.glob("*.pt")) if directory.exists() else []


class Checkpointer:
    def __init__(self, directory: str | Path, max_best: int = 3, monitor: str = "loss"):
        self.directory = Path(directory).absolute()
        self.max_best = max_best
        self.monitor = monitor
        self._last = self.directory / "last"
        self._best = self.directory / "best"

    def save(self, step: int, state, metrics: dict | None = None) -> None:
        """Save ``state.state_dict()`` as the newest checkpoint, and among the
        best when ``metrics`` holds the monitored value and ranks in the top
        ``max_best``."""
        sd = state.state_dict()
        self._last.mkdir(parents=True, exist_ok=True)
        _atomic_save(sd, self._last / f"{step}.pt")
        for old in _steps(self._last):
            if old != step:
                (self._last / f"{old}.pt").unlink()
        if metrics is None or self.monitor not in metrics:
            return
        index = self._index()
        index[str(step)] = {k: float(v) for k, v in metrics.items()}
        keep = sorted(index, key=lambda s: index[s][self.monitor])[: self.max_best]
        self._best.mkdir(parents=True, exist_ok=True)
        if str(step) in keep:
            _atomic_save(sd, self._best / f"{step}.pt")
        for s in set(index) - set(keep):
            (self._best / f"{s}.pt").unlink(missing_ok=True)
        (self._best / "index.json").write_text(json.dumps({s: index[s] for s in keep}))

    def _index(self) -> dict:
        path = self._best / "index.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def latest_step(self) -> int | None:
        steps = _steps(self._last)
        return steps[-1] if steps else None

    def restore_latest_raw(self) -> tuple[dict, int] | None:
        """The newest checkpoint as saved (``TrainState.state_dict()``: step,
        model, ema, optimizer) and its step, without a state to load it
        into, or None.  A finished run's weights are its ``ema``."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._last / f"{step}.pt", map_location="cpu", weights_only=True), step

    def restore_latest(self, state) -> int | None:
        """Load the newest checkpoint into ``state``; returns its step or None."""
        restored = self.restore_latest_raw()
        if restored is None:
            return None
        state.load_state_dict(restored[0])
        return restored[1]

    # -- hyperparameters-in-checkpoint ---------------------------------------

    @property
    def hparams_path(self) -> Path:
        return self.directory / "hparams.json"

    def save_hyperparameters(self, hparams: dict) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        self.hparams_path.write_text(json.dumps(hparams, indent=2, default=str))

    def restore_hyperparameters(self) -> dict | None:
        if self.hparams_path.exists():
            return json.loads(self.hparams_path.read_text())
        return None

    def verify_hyperparameters(self, hparams: dict, *, strict: bool = True) -> bool:
        """Compare against the stored hparams; on a mismatch raise (strict: a
        resume must not silently continue a different architecture) or
        warn.  True when stored hparams exist and match."""
        stored = self.restore_hyperparameters()
        if stored is None:
            return False
        diffs = _dict_diff(stored, json.loads(json.dumps(hparams, default=str)))
        if diffs:
            msg = (f"checkpoint hyperparameters at {self.hparams_path} do not match "
                   f"the requested configuration: {'; '.join(diffs[:8])}")
            if strict:
                raise ValueError(msg)
            logger.warning(msg)
            return False
        return True


def _dict_diff(a: dict, b: dict, prefix: str = "") -> list[str]:
    diffs = []
    for key in sorted(set(a) | set(b)):
        pa, pb = a.get(key, "<absent>"), b.get(key, "<absent>")
        path = f"{prefix}{key}"
        if isinstance(pa, dict) and isinstance(pb, dict):
            diffs += _dict_diff(pa, pb, prefix=path + ".")
        elif _norm(pa) != _norm(pb):
            diffs.append(f"{path}: stored={pa!r} requested={pb!r}")
    return diffs


def _norm(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v
