"""The numbers that decide ``correct``, each against its limit.

- ``rel_gap_rows``: the worst row's relative L2 distance between the
  program's answer and the reference's.
- ``norm_gap``: by leaf, the gap between the program's norm and the
  reference's (not the norm of their difference), over the reference's norm
  of that leaf or of the median leaf, whichever is larger; the worst leaf.
"""

from __future__ import annotations

import math
import statistics

import torch


def rel_gap_rows(program: torch.Tensor, reference: torch.Tensor) -> float:
    p = program.double().flatten(1)
    r = reference.double().to(p.device).flatten(1)
    gap = (p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)
    if not torch.isfinite(gap).all():
        return math.inf
    return float(gap.max())


def norm_gap(program: dict, reference: dict, keep=None) -> float:
    """``program`` and ``reference``: {leaf: norm}; ``keep``: the leaves to
    compare (default all)."""
    median = statistics.median(reference.values())
    worst = 0.0
    for k in keep if keep is not None else reference:
        p, r = program.get(k, math.nan), reference[k]  # a leaf the program lacks fails
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - r) / max(r, median, 1e-30))
    return worst


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {"value", "limit"}})."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
        ok &= math.isfinite(value) and value <= limit
    return ok, checks


class reference_precision:
    """float32 without TF32 (and with or without autograd) while the reference
    runs; the settings are restored after it."""

    def __init__(self, grad: bool):
        self.grad = grad

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.is_grad_enabled())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_grad_enabled(self.grad)
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         grad) = self.saved
        torch.set_grad_enabled(grad)
        return False
