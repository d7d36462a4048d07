"""Waveform quality heuristics -> validity indices: the port of
``tqdne_tpu/data/quality.py`` as batched torch on the caller's device.

The reference's offline filters (its
``scripts/preprocessing/05_raw_data_filter_indices.py``): trailing-zero
detection with an adaptive amplitude threshold, a tiny dynamic range,
linear-trend tails, and the last oscillating sample from zero-crossing
windows, the index that becomes ``indices_valid_waveforms`` and masks dead
tails in training and evaluation.

Every check takes a (..., T) tensor and runs where the tensor lies: a
tensor on the card is scanned on the card.  The results equal the JAX
package's exactly, as none of them rounds differently:

- the thresholds are max |x| times 0.001 in the input's dtype, then compares;
- the zero-crossing windows are integer sums;
- ``compute_validity_indices`` follows the JAX package's native scan
  (``csrc/fastops.cpp:validity_indices``): float32 samples, a sample counts
  as signed where x > thr or x < -thr, and a NaN neither counts nor raises
  the peak;
  ``find_last_oscillating_sample`` follows the numpy function (|x| >= thr);
  the two differ only on samples exactly at the threshold and on NaNs;
- ``check_linear_trend``'s window sums are float64 prefix sums taken one
  sample after another, the order numpy's ``cumsum`` adds in, and its
  divisions are true divisions, so the R^2 of every window is numpy's to the
  last bit on the host (a parallel scan would round the prefixes otherwise,
  and the differences of prefixes over a quiet tail amplify that into the
  R^2).  That is one small launch per sample on the card: about T launches
  for the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch


def _adaptive_threshold(waveform: torch.Tensor, peak: torch.Tensor | None = None) -> torch.Tensor:
    """0.1% of max |amplitude| with a 1e-10 floor, per trace, in the
    waveform's dtype (kept as a broadcastable (..., 1) tensor)."""
    if peak is None:
        peak = waveform.abs().amax(dim=-1, keepdim=True)
    return torch.clamp_min(peak * torch.tensor(0.001, dtype=peak.dtype), 1e-10)


def _last_index(mask: torch.Tensor) -> torch.Tensor:
    """1 + the index of the last True along the last axis, 0 where none."""
    n = mask.shape[-1]
    pos = torch.arange(1, n + 1, device=mask.device, dtype=torch.int64)
    return torch.where(mask, pos, 0).amax(dim=-1)


def check_trailing_zeros(waveform, n_samples: int = 100):
    """(has_trailing_zeros, index where the zeros start) per trace: a trace
    has trailing zeros when its last ``n_samples`` are all below the adaptive
    threshold; the index is one past the last live sample (-1 without)."""
    w = torch.as_tensor(waveform)
    quiet = w.abs() < _adaptive_threshold(w)
    has = quiet[..., -n_samples:].all(dim=-1)
    return has, torch.where(has, _last_index(~quiet), -1)


def check_small_range(waveform, threshold: float = 1e-5) -> torch.Tensor:
    """True where max - min < threshold (a dead channel)."""
    w = torch.as_tensor(waveform)
    return (w.amax(dim=-1) - w.amin(dim=-1)) < threshold


def _window_sums(x: torch.Tensor, window: int) -> torch.Tensor:
    """Integer sliding-window sums along the last axis: out[..., i] = sum x[i:i+w]."""
    c = torch.nn.functional.pad(torch.cumsum(x, dim=-1), (1, 0))
    return c[..., window:] - c[..., :-window]


def _last_oscillating(sgn: torch.Tensor, window: int, min_crossings: int) -> torch.Tensor:
    """The last-oscillating-sample index from per-sample signs in {-1, 0, 1}:
    a change is scored where a nonzero sign differs from the previous nonzero
    one; the last window of ``window`` samples holding ``min_crossings``
    changes ends the live signal (T // 2 where none does)."""
    n = sgn.shape[-1]
    nz = sgn != 0
    pos = torch.arange(n, device=sgn.device, dtype=torch.int32)
    last_nz = torch.cummax(torch.where(nz, pos, 0), dim=-1).values  # forward fill
    ffill = torch.gather(sgn, -1, last_nz.long())
    prev = torch.nn.functional.pad(ffill[..., :-1], (1, 0))
    change = nz & (prev != 0) & (sgn != prev)
    oscillating = _window_sums(change.to(torch.int32), window) >= min_crossings
    last = _last_index(oscillating)  # last window start + 1, 0 where none
    return torch.where(last > 0, last - 1 + window - 1, n // 2)


def find_last_oscillating_sample(waveform, window_size: int = 20,
                                 min_crossings: int = 2) -> torch.Tensor:
    """Index of the last sample inside a window that still oscillates (at
    least ``min_crossings`` sign changes among above-threshold samples), per
    trace: the numpy function's signs (0 where |x| < thr)."""
    w = torch.as_tensor(waveform)
    n = w.shape[-1]
    if n <= window_size * 2:
        return torch.full(w.shape[:-1], n // 2, dtype=torch.int64, device=w.device)
    thr = _adaptive_threshold(w)
    sgn = torch.where(w.abs() < thr, 0, torch.sign(w)).to(torch.int8)
    return _last_oscillating(sgn, window_size, min_crossings)


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis with a 0 in front, each the previous
    one plus the next sample: numpy's ``cumsum`` order and rounding, one add
    per sample over all rows at once."""
    rows = x.reshape(-1, x.shape[-1]).T.contiguous()  # (T, R): each step a contiguous row
    out = rows.new_zeros((rows.shape[0] + 1, rows.shape[1]))
    out[1] = rows[0]
    sums, samples = out.unbind(0), rows.unbind(0)
    for j in range(1, len(samples)):
        torch.add(sums[j], samples[j], out=sums[j + 1])
    return out.T.reshape(*x.shape[:-1], rows.shape[0] + 1)


def linear_trend_r2(waveform, min_segment_length: int = 300) -> torch.Tensor:
    """R^2 of the straight-line fit over each window of
    ``min_segment_length`` samples starting in the last third of the trace
    (where faults appear), from float64 window sums; 0 where the window's
    variance is below 1e-20.  (..., T) -> (..., windows)."""
    w = torch.as_tensor(waveform).to(torch.float64)
    n, m = w.shape[-1], min_segment_length
    t = np.arange(m)
    t_mean = float(t.mean())
    t_var = float(((t - t_mean) ** 2).sum())
    first = (n - m + 1) * 2 // 3  # the first tail window

    ramp = torch.arange(n, dtype=torch.float64, device=w.device)
    c = _sequential_cumsum(torch.stack([w, w * ramp, w * w]))
    sums = c[..., first + m:] - c[..., first:n - m + 1]
    sum_y, sum_ty_full, sum_y2 = sums[0], sums[1], sums[2]
    starts = torch.arange(first, n - m + 1, dtype=torch.float64, device=w.device)
    # divisors as device tensors: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which rounds otherwise than numpy's division
    t_var_, m_ = (torch.tensor(v, dtype=torch.float64, device=w.device) for v in (t_var, m))
    # sum_i (t_i * y_{s+i}) = sum_j ((j - s) * y_j) over the window
    sum_ty = sum_ty_full - starts * sum_y
    beta = (sum_ty - t_mean * sum_y) / t_var_
    y_mean = sum_y / m_
    ss_tot = sum_y2 - m * y_mean**2
    ss_reg = beta**2 * t_var
    return torch.where(ss_tot > 1e-20, ss_reg / ss_tot, 0.0)


def check_linear_trend(waveform, r_squared_threshold: float = 0.95,
                       min_segment_length: int = 300) -> torch.Tensor:
    """True where a window of the tail third is (almost exactly) a straight
    line, R^2 above the threshold: an instrument fault."""
    w = torch.as_tensor(waveform)
    if w.shape[-1] < min_segment_length:
        return torch.zeros(w.shape[:-1], dtype=torch.bool, device=w.device)
    return (linear_trend_r2(w, min_segment_length) > r_squared_threshold).any(dim=-1)


def compute_validity_indices(waveforms, window_size: int = 20,
                             min_crossings: int = 2) -> torch.Tensor:
    """Per-record validity index of (N, C, T) waveforms: the largest last
    oscillating sample across channels (the most conservative cut keeps
    every channel's live signal).  The native scan's semantics: signed where
    x > thr or x < -thr, NaNs ignored."""
    w = torch.as_tensor(waveforms).to(torch.float32)  # the native scan reads float32
    n = w.shape[-1]
    if n <= window_size * 2:
        return torch.full(w.shape[:-2], n // 2, dtype=torch.int64, device=w.device)
    a = w.abs()
    thr = _adaptive_threshold(w, torch.where(torch.isnan(a), 0, a).amax(dim=-1, keepdim=True))
    sgn = (w > thr).to(torch.int8) - (w < -thr).to(torch.int8)
    return _last_oscillating(sgn, window_size, min_crossings).amax(dim=-1)


def quality_report(waveforms) -> dict:
    """Per-record fault flags of (N, C, T) waveforms, on their device."""
    has_tz, tz_idx = check_trailing_zeros(waveforms)
    return {
        "has_trailing_zeros": has_tz.any(dim=-1),
        "trailing_zero_index": tz_idx.amin(dim=-1),
        "has_small_range": check_small_range(waveforms).any(dim=-1),
        "has_linear_trend": check_linear_trend(waveforms).any(dim=-1),
        "validity_index": compute_validity_indices(waveforms),
    }
