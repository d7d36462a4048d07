"""Offline preprocessing primitives: the port of
``tqdne_tpu/data/preprocessing.py`` (numpy and scipy, as there).

The dependency-free cores of the reference's ``scripts/preprocessing``
pipeline and its STEAD dataset script, vectorized and without obspy or seisbench:
- NaN gap repair: linear interpolation and iterative frequency-constrained
  (POCS) reconstruction (02_extractMatFileWaveform.py)
- geodesy: great-circle azimuth (the core of obspy's gps2dist_azimuth) and
  the azimuthal-gap metric (create_dataset_from_STEAD.py)
- STA/LTA onset picking for trace alignment (obspy's classic_sta_lta
  definition, as write_to_seisbench.py uses it)
- record selection filters (01_preprocess.py: rhyp <= 200 km,
  4 <= mag <= 10, depth <= 100 km) and common-grid resampling (demean, causal
  0.1 Hz highpass, polyphase resample to 100 Hz)
- ``IncrementalH5Writer``, resumable per-record HDF5 writes (``h5py`` is
  imported where a file is opened)

Steps that need station metadata or an instrument response (response
removal, KNET calibration) or PhaseNet picks keep the reference's role but
sit behind optional imports (obspy, seisbench).
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sp_signal

# --------------------------------------------------------------------------
# NaN gap repair
# --------------------------------------------------------------------------


def linear_interpolate_nans(sig: np.ndarray) -> np.ndarray:
    """Fill NaNs by linear interpolation along the last axis, batched."""
    sig = np.array(sig, np.float64, copy=True)
    flat = sig.reshape(-1, sig.shape[-1])
    idx = np.arange(sig.shape[-1])
    for row in flat:
        bad = np.isnan(row)
        if bad.any() and not bad.all():
            row[bad] = np.interp(idx[bad], idx[~bad], row[~bad])
    return sig


def spectral_gap_fill(
    sig: np.ndarray,
    fs: float = 100.0,
    num_iters: int = 100,
    tol: float = 1e-4,
    f_low: float = 0.1,
    f_high: float = 50.0,
    adaptive_band: bool = False,
) -> np.ndarray:
    """Iterative frequency-constrained (POCS) gap reconstruction of a 1D
    trace with NaNs (02:294-359): band-limit in the Fourier domain, then
    re-impose the valid samples, until convergence.

    The reference fixes the band to [0.1, 50] Hz (its analyze_frequency
    computes a 5%-power threshold but discards it, 02:287-291) — at
    100 Hz sampling that only removes DC, so the fill degenerates to
    linear interpolation.  ``adaptive_band=True`` enables the evidently
    intended behavior: keep only frequencies whose power in the
    interpolated signal exceeds 5% of the peak, which reconstructs
    band-limited signals through gaps far more faithfully.
    """
    sig = np.asarray(sig, np.float64)
    n = len(sig)
    valid = ~np.isnan(sig)
    if valid.sum() <= (~valid).sum():
        raise ValueError(
            f"Insufficient valid data points (valid={int(valid.sum())}, "
            f"missing={int((~valid).sum())})"
        )
    x = linear_interpolate_nans(sig)
    freqs = np.fft.fftfreq(n, d=1 / fs)
    if adaptive_band:
        power = np.abs(np.fft.fft(x)) ** 2
        mask = power > 0.05 * power.max()
        mask &= np.abs(freqs) >= f_low
    else:
        mask = (np.abs(freqs) >= f_low) & (np.abs(freqs) <= f_high)

    x_old = x.copy()
    for _ in range(num_iters):
        spec = np.fft.fft(x)
        spec[~mask] = 0
        x_new = np.fft.ifft(spec).real
        x_new[valid] = sig[valid]
        if np.linalg.norm(x_new - x_old) < tol:
            return x_new
        x_old, x = x_new.copy(), x_new
    return x


# --------------------------------------------------------------------------
# geodesy / azimuthal gap
# --------------------------------------------------------------------------


def azimuth_deg(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Great-circle forward azimuth (degrees clockwise from north) from
    point 1 to point 2 on a sphere (the core of obspy gps2dist_azimuth;
    the ~0.2% spheroid correction is irrelevant for gap statistics)."""
    la1, lo1, la2, lo2 = map(np.radians, (lat1, lon1, lat2, lon2))
    dlon = lo2 - lo1
    y = np.sin(dlon) * np.cos(la2)
    x = np.cos(la1) * np.sin(la2) - np.sin(la1) * np.cos(la2) * np.cos(dlon)
    return (np.degrees(np.arctan2(y, x)) + 360.0) % 360.0


def azimuthal_gap(hypocenter, station_coords) -> float:
    """Largest angular gap between consecutive station azimuths seen from
    the hypocenter (create_dataset_from_STEAD.py:65-111 semantics,
    including the single-station fallback to the azimuth itself)."""
    hypo_lat, hypo_lon = hypocenter
    coords = np.atleast_2d(np.asarray(station_coords, np.float64))
    az = np.sort(azimuth_deg(hypo_lat, hypo_lon, coords[:, 0], coords[:, 1]))
    if len(az) < 2:
        return float(az[-1])
    gaps = np.diff(az)
    wrap = 360.0 - (az[-1] - az[0])
    return float(max(gaps.max(), wrap))


# --------------------------------------------------------------------------
# onset picking
# --------------------------------------------------------------------------


def classic_sta_lta(trace: np.ndarray, nsta: int, nlta: int) -> np.ndarray:
    """Classic STA/LTA characteristic function on x^2 (obspy-compatible
    definition), vectorized along the last axis."""
    trace = np.asarray(trace, np.float64)
    sq = trace**2
    c = np.concatenate(
        [np.zeros(sq.shape[:-1] + (1,)), np.cumsum(sq, axis=-1)], axis=-1
    )
    n = sq.shape[-1]
    i = np.arange(n)
    sta_lo = np.maximum(i - nsta + 1, 0)
    lta_lo = np.maximum(i - nlta + 1, 0)
    sta = (np.take(c, i + 1, axis=-1) - np.take(c, sta_lo, axis=-1)) / nsta
    lta = (np.take(c, i + 1, axis=-1) - np.take(c, lta_lo, axis=-1)) / nlta
    ratio = np.where(lta > 1e-20, sta / np.maximum(lta, 1e-20), 0.0)
    # obspy zeroes the warm-up region
    ratio[..., : nlta] = 0.0
    return ratio


def pick_onset(
    trace: np.ndarray, fs: float = 100.0, sta_s: float = 0.5, lta_s: float = 10.0,
    threshold: float = 2.0,
) -> np.ndarray:
    """First sample where STA/LTA crosses the trigger threshold, batched;
    falls back to the characteristic-function argmax when no crossing
    (write_to_seisbench.py:166-175 role)."""
    cf = classic_sta_lta(trace, int(sta_s * fs), int(lta_s * fs))
    above = cf >= threshold
    has = above.any(axis=-1)
    first = np.argmax(above, axis=-1)
    return np.where(has, first, np.argmax(cf, axis=-1))


# --------------------------------------------------------------------------
# record selection + resampling
# --------------------------------------------------------------------------


def select_records(
    rhyp: np.ndarray, mag: np.ndarray, depth: np.ndarray,
    max_dist: float = 200.0, mag_range=(4.0, 10.0), max_depth: float = 100.0,
) -> np.ndarray:
    """Catalog selection mask (01_preprocess.py:343-350)."""
    return (
        (np.asarray(rhyp) <= max_dist)
        & (np.asarray(mag) >= mag_range[0])
        & (np.asarray(mag) <= mag_range[1])
        & (np.asarray(depth) <= max_depth)
    )


def preprocess_trace(
    trace: np.ndarray, fs_in: float, fs_out: float = 100.0, highpass_hz: float = 0.1,
) -> np.ndarray:
    """Demean + causal 4th-order Butterworth highpass + polyphase resample
    (01_preprocess.py:462-472 demean/detrend/filter, :354-356 common grid)."""
    x = np.asarray(trace, np.float64)
    x = x - x.mean(axis=-1, keepdims=True)
    x = sp_signal.detrend(x, axis=-1, type="linear")
    b, a = sp_signal.butter(4, highpass_hz / (0.5 * fs_in), btype="high")
    x = sp_signal.lfilter(b, a, x, axis=-1)
    if fs_in != fs_out:
        from fractions import Fraction

        frac = Fraction(fs_out / fs_in).limit_denominator(1000)
        x = sp_signal.resample_poly(x, frac.numerator, frac.denominator, axis=-1)
    return x


def p_window_filter(
    waveforms: np.ndarray,
    fs: float = 100.0,
    window_s: tuple[float, float] = (2.0, 7.0),
    vertical_channel: int = 2,
) -> np.ndarray:
    """Keep records whose picked P onset falls inside the expected window
    (04_filter_waveforms.py role: re-pick and drop misaligned records;
    the reference uses PhaseNet — here the STA/LTA picker).

    Short STA/LTA windows (0.3 s / 1.5 s) keep the warm-up region below
    the window start so onsets as early as 2 s are detectable.
    """
    picks = pick_onset(
        np.asarray(waveforms)[:, vertical_channel], fs, sta_s=0.3, lta_s=1.5
    )
    lo, hi = int(window_s[0] * fs), int(window_s[1] * fs)
    return (picks >= lo) & (picks <= hi)


class IncrementalH5Writer:
    """Append-mode HDF5 writing with processed-key tracking + diary log —
    the offline pipeline's resumability pattern
    (01_preprocess.py:194-298,387-397): every item lands incrementally,
    a restart skips already-processed keys, and a human-readable diary
    records progress."""

    def __init__(self, path, diary_path=None):
        import h5py

        self.path = str(path)
        self.file = h5py.File(self.path, "a")
        self.diary_path = str(diary_path) if diary_path else self.path + ".diary"

    @property
    def processed_keys(self) -> set[str]:
        return set(self.file.keys())

    def is_processed(self, key: str) -> bool:
        return key in self.file

    def write(self, key: str, arrays: dict):
        if self.is_processed(key):
            return False
        grp = self.file.create_group(key)
        for name, arr in arrays.items():
            grp.create_dataset(name, data=np.asarray(arr))
        self.file.flush()
        with open(self.diary_path, "a") as diary:
            diary.write(f"{key}\n")
        return True

    def close(self):
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def cut_around_onset(
    trace: np.ndarray, onset: int, pre: int, total: int
) -> np.ndarray:
    """Cut [onset-pre, onset-pre+total) with zero padding (03/04 alignment)."""
    trace = np.asarray(trace)
    start = onset - pre
    out = np.zeros(trace.shape[:-1] + (total,), trace.dtype)
    src_lo = max(start, 0)
    src_hi = min(start + total, trace.shape[-1])
    if src_hi > src_lo:
        dst_lo = src_lo - start
        out[..., dst_lo : dst_lo + (src_hi - src_lo)] = trace[..., src_lo:src_hi]
    return out
