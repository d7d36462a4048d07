"""Seismological evaluation: the port of ``tqdne_tpu/eval/seismo.py``.

The batched intensity measures run in float64 torch on their input's device
(an array goes to the CPU): the rotation-invariant peak and GMRotD50
(``np.percentile``'s linear interpolation is ``torch.quantile``),
frequency-domain integration and highpass (``torch.fft``), ``evaluate_pgx``,
Arias intensity and D5-95, and the 5%-damped response spectrum with its
RotD percentile (``sa_rotd``).  ``sa_distance`` and the residual report
(``eval.residuals``) take a ``device``, ``cuda`` unless the caller asks for
the CPU.

The scalar and host parts stay numpy, as in the JAX package: the
distance-binned statistics, PGA -> MMI, the ground-motion models (Kanno et
al. 2006 shallow, Boore et al. 2014, the EPRI distance adjustment, and
``gmm_curve``, which prefers OpenQuake when it is importable), the causal
Butterworth highpass (scipy) and the ShakeMap colormap (matplotlib, imported
when it is called).

**The response spectrum on the device.**  The Nigam-Jennings recursion
x_{i+1} = A x_i + B [a_i, a_{i+1}] from x_0 = 0 is linear and
time-invariant, and A is the oscillator's transition matrix over dt, so
A^m is the same matrix taken at m dt.  The displacement is therefore an
exact causal convolution, x_n = sum_{i<n} h1[n-1-i] a_i + h2[n-1-i] a_{i+1}
with [h1, h2][m] = (A^m B)[0, :], which one zero-padded float64 ``rfft`` of
length >= 2T - 1 computes for every row and period at once.
``response_spectrum_loop`` keeps the JAX loop as the plain version that the
tests and the GPU smoke run hold it against.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import signal as sp_signal

from tqdne_tpu_torch.utils import resolve_device

BUDGET_BYTES = 1 << 29  # device memory a chunk of rows may take in gmrotd50 and the spectrum


def _f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor on ``device``, by default its own (an array's
    is the CPU)."""
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _rows_per_chunk(bytes_per_row: int) -> int:
    return max(1, BUDGET_BYTES // max(bytes_per_row, 1))


# --------------------------------------------------------------------------
# peak ground motion
# --------------------------------------------------------------------------


def rotation_invariant_peak(c1, c2) -> torch.Tensor:
    """max_t sqrt(c1(t)^2 + c2(t)^2), batched over leading axes: the median
    over angles of the reference's per-angle sqrt(r1^2 + r2^2), which does
    not depend on the angle."""
    c1, c2 = _f64(c1), _f64(c2)
    return torch.sqrt(c1**2 + c2**2).amax(dim=-1)


def gmrotd50(c1, c2, num_angles: int = 90) -> torch.Tensor:
    """GMRotD50 (Boore et al. 2006): the median over non-redundant rotation
    angles of the geometric mean of the two rotated components' peaks.
    c1, c2 are (..., T); returns (...).  Rows go in chunks so that the
    (rows, angles, T) rotations stay within ``BUDGET_BYTES``."""
    c1, c2 = _f64(c1), _f64(c2)
    batch_shape, t = c1.shape[:-1], c1.shape[-1]
    thetas = torch.deg2rad(torch.arange(num_angles, dtype=torch.float64, device=c1.device)
                           * (90.0 / num_angles))
    cos, sin = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]
    a, b = c1.reshape(-1, t), c2.reshape(-1, t)
    out, step = [], _rows_per_chunk(2 * num_angles * t * 8)
    for s in range(0, len(a), step):
        x, y = a[s:s + step], b[s:s + step]
        r1 = x[:, None, :] * cos + y[:, None, :] * sin
        r2 = -x[:, None, :] * sin + y[:, None, :] * cos
        gm = torch.sqrt(r1.abs().amax(dim=-1) * r2.abs().amax(dim=-1))  # (rows, A)
        out.append(torch.quantile(gm, 0.5, dim=-1))
    return torch.cat(out).reshape(batch_shape) if out else a.new_zeros(batch_shape)


# --------------------------------------------------------------------------
# integration / filtering
# --------------------------------------------------------------------------


def integrate_frequency_domain(sig, dt: float, highpass_hz: float = 0.1) -> torch.Tensor:
    """Acceleration -> velocity: division by j omega in the frequency domain
    under a highpass mask, batched over rows.  The real FFT gives the real
    part of the JAX package's full inverse FFT (the Nyquist bin turns
    imaginary there and drops out of both)."""
    sig = _f64(sig)
    n = sig.shape[-1]
    spec = torch.fft.rfft(sig, dim=-1)
    freqs = torch.fft.rfftfreq(n, dt, dtype=torch.float64, device=sig.device)
    spec = spec * (freqs.abs() >= highpass_hz)
    spec[..., 1:] = spec[..., 1:] / (1j * 2 * math.pi * freqs[1:])
    spec[..., 0] = 0
    return torch.fft.irfft(spec, n=n, dim=-1)


def filter_frequency_domain(sig, dt: float, highpass_hz: float = 0.1) -> torch.Tensor:
    """Zero-phase highpass mask in the frequency domain, batched."""
    sig = _f64(sig)
    n = sig.shape[-1]
    freqs = torch.fft.rfftfreq(n, dt, dtype=torch.float64, device=sig.device)
    return torch.fft.irfft(torch.fft.rfft(sig, dim=-1) * (freqs.abs() >= highpass_hz), n=n,
                           dim=-1)


def highpass_filter(data: np.ndarray, cutoff_freq: float = 0.1, sampling_rate: float = 100.0):
    """Causal 4th-order Butterworth highpass along the last axis (host, scipy)."""
    nyquist = 0.5 * sampling_rate
    b, a = sp_signal.butter(4, cutoff_freq / nyquist, btype="high")
    return sp_signal.lfilter(b, a, data, axis=-1)


# --------------------------------------------------------------------------
# observed-vs-generated ratio statistics
# --------------------------------------------------------------------------


def evaluate_pgx(target, predicted, dt: float = 0.01, pgv: bool = True,
                 evaluate_obs: bool = True):
    """Peak ground motions of observed and generated waveforms (N, >= 2, T),
    channels 0 and 1 the horizontals, on their device: velocity peaks after
    integration (``pgv``), else the highpassed acceleration's.  Returns
    ``{"<IM>_geom_mean_obs": ..., "<IM>_geom_mean_gwm": ...}`` (N,) tensors,
    or the generated peaks alone without ``evaluate_obs``."""
    def process(batch):
        h1, h2 = batch[:, 0], batch[:, 1]
        step = integrate_frequency_domain if pgv else filter_frequency_domain
        return rotation_invariant_peak(step(h1, dt), step(h2, dt))

    key = "PGV_geom_mean" if pgv else "PGA_geom_mean"
    pred_vals = process(_f64(predicted))
    if not evaluate_obs:
        return pred_vals
    return {f"{key}_obs": process(_f64(target)), f"{key}_gwm": pred_vals}


def calculate_distance_binned_ratios(pgx_obs, pgx_gen, hypocentral_distance,
                                     n_bins: int = 50) -> dict:
    """Distance-binned statistics of log10(obs / gen) (host)."""
    pgx_obs = np.asarray(pgx_obs)
    pgx_gen = np.asarray(pgx_gen)
    dist = np.asarray(hypocentral_distance)
    if not (len(pgx_obs) == len(pgx_gen) == len(dist)):
        raise ValueError("Input arrays must have the same length")

    ratio = np.log10(pgx_obs / pgx_gen)
    edges = np.linspace(dist.min(), dist.max(), n_bins)
    centers, median, std, counts = [], [], [], []
    for i in range(len(edges) - 1):
        idx = np.where((dist > edges[i]) & (dist <= edges[i + 1]))[0]
        centers.append(0.5 * (edges[i] + edges[i + 1]))
        if len(idx) > 0:
            median.append(np.median(ratio[idx]))
            std.append(np.std(ratio[idx]))
            counts.append(len(idx))
        else:
            median.append(np.nan)
            std.append(np.nan)
            counts.append(0)
    return {
        "bin_centers": np.array(centers),
        "median_ratios": np.array(median),
        "std_ratios": np.array(std),
        "bin_counts": np.array(counts),
        "bin_edges": edges,
        "ratio_values": ratio,
    }


# --------------------------------------------------------------------------
# intensity measures
# --------------------------------------------------------------------------


def pga_to_mmi(pga, unit: str = "g") -> np.ndarray:
    """PGA -> Modified Mercalli Intensity: MMI = 3.66 log10(PGA[g]) + 1.66 (host)."""
    pga = np.asarray(pga, np.float64)
    if unit == "m/s^2" or unit == "m/s2":
        pga = pga / 9.80665
    elif unit == "cm/s^2" or unit == "cm/s2":
        pga = pga / 980.665
    return 3.66 * np.log10(np.maximum(pga, 1e-12)) + 1.66


def shakemap_colormap(mmi=None):
    """The ShakeMap MMI colormap: the standard 11-edge colour scale linearly
    interpolated over the given MMI values (imports matplotlib)."""
    from matplotlib.colors import LinearSegmentedColormap

    if mmi is None:
        mmi = np.linspace(1, 10, 256)
    edges = np.array(
        [
            [255, 255, 255], [191, 204, 255], [160, 230, 255], [128, 255, 255],
            [122, 255, 147], [255, 255, 0], [255, 200, 0], [255, 145, 0],
            [255, 0, 0], [200, 0, 0], [128, 0, 0],
        ],
        dtype=np.float64,
    ) / 255.0
    mmi_values = np.arange(1, 12)
    colors = np.stack([np.interp(mmi, mmi_values, edges[:, i]) for i in range(3)], axis=1)
    return LinearSegmentedColormap.from_list("ShakeMapMMI", colors, N=len(colors))


def arias_intensity(acc, dt: float, g: float = 9.80665) -> torch.Tensor:
    """Arias intensity Ia = pi / (2 g) * integral a(t)^2 dt, batched."""
    return math.pi / (2 * g) * torch.trapezoid(_f64(acc) ** 2, dx=dt, dim=-1)


def significant_duration(acc, dt: float, lo=0.05, hi=0.95) -> torch.Tensor:
    """D_{5-95}: the time between 5% and 95% of the cumulative Arias
    intensity (the first sample at or past each level)."""
    acc = _f64(acc)
    cum = torch.cumsum(acc**2, dim=-1)
    norm = cum / cum[..., -1:].clamp(min=1e-30)
    # argmax takes no bool; it returns the first maximum, as numpy's does
    t_lo = (norm >= lo).to(torch.uint8).argmax(dim=-1)
    t_hi = (norm >= hi).to(torch.uint8).argmax(dim=-1)
    return (t_hi - t_lo).to(torch.float64) * dt


# --------------------------------------------------------------------------
# response spectra (Nigam-Jennings exact piecewise integration)
# --------------------------------------------------------------------------


def _oscillator(period: float, dt: float, damping: float) -> tuple:
    """(wn, wd, A over dt as a11, a12, a21, a22, B as b11, b12, b21, b22) of
    the Nigam-Jennings recursion for one period."""
    wn = 2 * math.pi / period
    root = math.sqrt(1 - damping**2)
    wd = wn * root
    e = math.exp(-damping * wn * dt)
    s, c = math.sin(wd * dt), math.cos(wd * dt)
    a11 = e * (c + damping / root * s)
    a12 = e / wd * s
    a21 = -wn / root * e * s
    a22 = e * (c - damping / root * s)
    zw3 = (2 * damping**2 - 1) / (wn**2 * dt)
    zw = 2 * damping / (wn**3 * dt)
    b11 = e * (s / wd * (zw3 + damping / wn) + c * (zw + 1 / wn**2)) - zw
    b12 = -e * (s / wd * zw3 + c * zw) - 1 / wn**2 + zw
    b21 = (e * ((zw3 + damping / wn) * (c - damping / root * s)
                - (zw + 1 / wn**2) * (wd * s + damping * wn * c))
           + 1 / (wn**2 * dt))
    b22 = (-e * (zw3 * (c - damping / root * s) - zw * (wd * s + damping * wn * c))
           - 1 / (wn**2 * dt))
    return wn, wd, (a11, a12, a21, a22), (b11, b12, b21, b22)


def response_spectrum(acc, dt: float, periods, damping: float = 0.05) -> torch.Tensor:
    """5%-damped pseudo-spectral acceleration SA(T), batched: ``acc`` (..., T)
    ground acceleration, ``periods`` the oscillator periods [s]; returns
    (..., len(periods)) on ``acc``'s device, float64.

    The displacement x_n (n = 1..T-1) of the Nigam & Jennings (1969)
    recursion is conv(g, a)[n] - h2[n] a_0 with g[0] = h2[0], g[m] = h2[m] +
    h1[m - 1], where [h1, h2][m] = (A^m B)[0, :] and A^m is the transition
    matrix at m dt: one FFT of each row, one of each period's g, and one
    inverse for every (row, period).  SA = wn^2 max_n |x_n|."""
    acc = _f64(acc)
    batch_shape, n = acc.shape[:-1], acc.shape[-1]
    flat = acc.reshape(-1, n)
    dev = acc.device
    out = torch.zeros(flat.shape[0], len(periods), dtype=torch.float64, device=dev)
    if n < 2 or not len(periods):
        return out.reshape(*batch_shape, len(periods))
    nfft = 1 << (2 * n - 2).bit_length()  # the least power of two >= 2n - 1
    tau = torch.arange(n, dtype=torch.float64, device=dev) * dt
    filters, h2s, wn2 = [], [], []
    for period in periods:
        wn, wd, _, (b11, b12, b21, b22) = _oscillator(period, dt, damping)
        e = torch.exp(-damping * wn * tau)
        s, c = torch.sin(wd * tau), torch.cos(wd * tau)
        a11 = e * (c + damping / math.sqrt(1 - damping**2) * s)  # A^m, from the formulas at m dt
        a12 = e / wd * s
        h1, h2 = a11 * b11 + a12 * b21, a11 * b12 + a12 * b22
        g = h2.clone()
        g[1:] += h1[:-1]
        filters.append(g)
        h2s.append(h2[1:])
        wn2.append(wn**2)
    g_f = torch.fft.rfft(torch.stack(filters), n=nfft, dim=-1)  # (P, F)
    h2s, wn2 = torch.stack(h2s), torch.tensor(wn2, dtype=torch.float64, device=dev)
    step = _rows_per_chunk(32 * len(periods) * nfft)
    for s in range(0, flat.shape[0], step):
        rows = flat[s:s + step]
        a_f = torch.fft.rfft(rows, n=nfft, dim=-1)  # (R, F)
        y = torch.fft.irfft(a_f[:, None, :] * g_f, n=nfft, dim=-1)[..., 1:n]  # (R, P, n - 1)
        disp = y - h2s * rows[:, None, :1]
        out[s:s + step] = disp.abs().amax(dim=-1) * wn2
    return out.reshape(*batch_shape, len(periods))


def response_spectrum_loop(acc, dt: float, periods, damping: float = 0.05) -> torch.Tensor:
    """The plain version of ``response_spectrum``: the JAX package's loop of
    T - 1 recursion steps for each period, over the whole batch, on
    ``acc``'s device."""
    acc = _f64(acc)
    batch_shape = acc.shape[:-1]
    flat = acc.reshape(-1, acc.shape[-1])
    out = torch.empty(flat.shape[0], len(periods), dtype=torch.float64, device=acc.device)
    for pi, period in enumerate(periods):
        wn, _, (a11, a12, a21, a22), (b11, b12, b21, b22) = _oscillator(period, dt, damping)
        x = flat.new_zeros(flat.shape[0])
        v = flat.new_zeros(flat.shape[0])
        peak = flat.new_zeros(flat.shape[0])
        for i in range(flat.shape[1] - 1):
            ai, aj = flat[:, i], flat[:, i + 1]
            x, v = a11 * x + a12 * v + b11 * ai + b12 * aj, a21 * x + a22 * v + b21 * ai + b22 * aj
            peak = torch.maximum(peak, x.abs())
        out[:, pi] = peak * wn**2  # pseudo-spectral acceleration
    return out.reshape(*batch_shape, len(periods))


def sa_rotd(c1, c2, dt: float, periods, *, percentile: float = 50.0, num_angles: int = 18,
            damping: float = 0.05, spectrum=response_spectrum) -> torch.Tensor:
    """RotD{percentile} spectral acceleration: the SA of each rotated
    horizontal component, then the percentile over the angles.  c1, c2 are
    (..., T); returns (..., len(periods)) on their device.  Rows go in chunks
    so that the (angles, rows, T) rotations stay within ``BUDGET_BYTES``.
    ``spectrum``: ``response_spectrum``, or its plain version for a reference."""
    c1, c2 = _f64(c1), _f64(c2)
    batch_shape, t = c1.shape[:-1], c1.shape[-1]
    thetas = torch.deg2rad(torch.arange(num_angles, dtype=torch.float64, device=c1.device)
                           * (180.0 / num_angles))
    cos, sin = torch.cos(thetas)[:, None, None], torch.sin(thetas)[:, None, None]
    a, b = c1.reshape(-1, t), c2.reshape(-1, t)
    out, step = [], _rows_per_chunk(num_angles * t * 8)
    for s in range(0, len(a), step):
        rotated = a[None, s:s + step] * cos + b[None, s:s + step] * sin  # (A, rows, T)
        sa = spectrum(rotated, dt, periods, damping)  # (A, rows, P)
        out.append(torch.quantile(sa, percentile / 100, dim=0))
    if not out:
        return a.new_zeros(*batch_shape, len(periods))
    return torch.cat(out).reshape(*batch_shape, len(periods))


def _distance_binned_percentiles(values, dist, edges):
    """Distance-binned median / 16th / 84th percentiles of (N, P) values
    (host); returns (centers, p50, p16, p84), NaN for empty bins."""
    values = np.asarray(values, np.float64)
    dist = np.asarray(dist, np.float64)
    nb = len(edges) - 1
    centers = 0.5 * (edges[:-1] + edges[1:])
    p50 = np.full((nb, values.shape[-1]), np.nan)
    p16 = np.full_like(p50, np.nan)
    p84 = np.full_like(p50, np.nan)
    for i in range(nb):
        m = (dist > edges[i]) & (dist <= edges[i + 1])
        if m.any():
            p50[i] = np.percentile(values[m], 50, axis=0)
            p16[i] = np.percentile(values[m], 16, axis=0)
            p84[i] = np.percentile(values[m], 84, axis=0)
    return centers, p50, p16, p84


def sa_distance(wf_ns, wf_ew, rhyp, dt: float, periods=(0.1, 0.3, 1.0, 2.0), *,
                obs_ns=None, obs_ew=None, obs_rhyp=None, mag: float | None = None,
                vs30: float = 400.0, percentile: float = 50.0, n_bins: int = 100,
                bin_range: tuple[float, float] = (0.1, 190.0),
                gmm_models: tuple[str, ...] = ("Kanno2006Shallow", "BooreEtAl2014"),
                device="cuda") -> dict:
    """SA(T) against hypocentral distance: RotD{percentile} SA(T) of the
    generated horizontal pairs on ``device``, its distance-binned median with
    the 16th and 84th percentiles, the same for an observed set when given,
    and, with ``mag``, each GMM's median SA(T) curve at the same periods.  A
    model whose built-in form has no SA period is recorded under
    ``gmm_skipped``.  The arrays returned are numpy."""
    device = resolve_device(device)
    periods = list(periods)
    rhyp = np.asarray(rhyp)
    sa = sa_rotd(_f64(wf_ns, device), _f64(wf_ew, device), dt, periods,
                 percentile=percentile).cpu().numpy()
    out = {"periods": periods, "rhyp": rhyp, "sa": sa}
    edges = np.linspace(bin_range[0], bin_range[1], n_bins + 1)  # n_bins bins
    out["bin_centers"], out["sa_median"], out["sa_p16"], out["sa_p84"] = (
        _distance_binned_percentiles(sa, rhyp, edges))
    if obs_ns is not None and obs_ew is not None and obs_rhyp is not None:
        sa_obs = sa_rotd(_f64(obs_ns, device), _f64(obs_ew, device), dt, periods,
                         percentile=percentile).cpu().numpy()
        out["obs_sa"] = sa_obs
        out["obs_rhyp"] = np.asarray(obs_rhyp)
        _, out["obs_sa_median"], out["obs_sa_p16"], out["obs_sa_p84"] = (
            _distance_binned_percentiles(sa_obs, obs_rhyp, edges))
    if mag is not None:
        grid = np.linspace(max(1.0, np.min(rhyp)), np.max(rhyp), 50)
        out["gmm_distances"] = grid
        out["gmm_sa"], out["gmm_skipped"] = {}, {}
        for model in gmm_models:
            curves, skipped = [], None
            for period in periods:
                try:
                    curves.append(gmm_curve(f"SA({period})", mag, grid, vs30, model=model))
                except NotImplementedError as e:
                    skipped = str(e)
                    break
            if skipped is None:
                out["gmm_sa"][model] = np.stack(curves, axis=-1)  # (50, P)
            else:
                out["gmm_skipped"][model] = skipped
    return out


# --------------------------------------------------------------------------
# ground motion models (host)
# --------------------------------------------------------------------------

# Kanno et al. (2006), BSSA 96(3): shallow-event (D <= 30 km) coefficients for
# PGA [cm/s^2] and PGV [cm/s]:
#   log10 pre = a*Mw + b*X - log10(X + d*10^(e*Mw)) + c
# with the site correction G = p*log10(Vs30) + q.
_KANNO2006_SHALLOW = {
    "PGA": dict(a=0.56, b=-0.0031, c=0.26, d=0.0055, e=0.5, p=-0.55, q=1.35),
    "PGV": dict(a=0.70, b=-0.0009, c=-1.93, d=0.0022, e=0.42, p=-0.71, q=1.77),
}


def kanno2006_shallow(imt: str, mag: float, rrup, vs30: float = 400.0) -> np.ndarray:
    """Median Kanno et al. (2006) shallow prediction for PGA [cm/s^2] or PGV
    [cm/s] at rupture distances ``rrup`` [km]."""
    if imt.upper() not in _KANNO2006_SHALLOW:
        raise NotImplementedError(
            f"Kanno2006Shallow built-in supports PGA/PGV; {imt} requires openquake")
    cf = _KANNO2006_SHALLOW[imt.upper()]
    rrup = np.asarray(rrup, np.float64)
    log_pre = (cf["a"] * mag + cf["b"] * rrup - np.log10(rrup + cf["d"] * 10 ** (cf["e"] * mag))
               + cf["c"])
    site = cf["p"] * np.log10(vs30) + cf["q"]
    return 10 ** (log_pre + site)


# Boore, Stewart, Seyhan & Atkinson (2014), Earthquake Spectra 30(3): the
# median (global region) with the mechanism-dependent event term, geometric +
# anelastic path term, and linear + nonlinear site response with the rock-PGA
# recursion; the published PGA and PGV rows.  SA periods would need the
# electronic supplement's rows: they raise NotImplementedError.
_BSSA14 = {
    "PGA": dict(e0=0.4473, e1=0.4856, e2=0.2459, e3=0.4539, e4=1.431, e5=0.05053,
                e6=-0.1662, Mh=5.5, c1=-1.134, c2=0.1917, c3=-0.00809, h=4.5,
                c=-0.600, Vc=1500.0, f4=-0.150, f5=-0.00701),
    "PGV": dict(e0=5.037, e1=5.078, e2=4.849, e3=5.033, e4=1.073, e5=-0.1536,
                e6=0.2252, Mh=6.2, c1=-1.243, c2=0.1489, c3=-0.00344, h=5.3,
                c=-0.840, Vc=1300.0, f4=-0.100, f5=-0.00844),
}
_BSSA14_MREF, _BSSA14_RREF, _BSSA14_VREF = 4.5, 1.0, 760.0
_BSSA14_F1, _BSSA14_F3 = 0.0, 0.1  # nonlinear-site constants (g)


def _bssa14_mech(rake: float | None) -> str:
    """Rake angle -> mechanism term: strike-slip |rake| < 30 or > 150, normal
    -150..-30, reverse 30..150, unspecified when rake is None."""
    if rake is None:
        return "e0"
    if abs(rake) < 30 or abs(rake) > 150:
        return "e1"  # strike-slip
    if -150 <= rake <= -30:
        return "e2"  # normal
    return "e3"  # reverse


def _bssa14_event_path(cf: dict, mag: float, rjb, mech: str):
    """F_E + F_P (the paper's eqs. 2-3), no site term."""
    rjb = np.asarray(rjb, np.float64)
    dm = mag - cf["Mh"]
    if mag <= cf["Mh"]:
        fe = cf[mech] + cf["e4"] * dm + cf["e5"] * dm * dm
    else:
        fe = cf[mech] + cf["e6"] * dm
    r = np.sqrt(rjb * rjb + cf["h"] * cf["h"])
    fp = (cf["c1"] + cf["c2"] * (mag - _BSSA14_MREF)) * np.log(r / _BSSA14_RREF) + cf["c3"] * (
        r - _BSSA14_RREF)
    return fe + fp


def boore_etal_2014(imt: str, mag: float, rjb, vs30: float = 760.0,
                    rake: float | None = None) -> np.ndarray:
    """Median BooreEtAl2014 prediction: PGA [g] or PGV [cm/s] at
    Joyner-Boore distances ``rjb`` [km], with the linear site term
    c ln(min(V, Vc) / 760) and the nonlinear f1 + f2 ln((PGA_r + f3) / f3)
    over the rock PGA of the same scenario."""
    key = imt.upper()
    if key not in _BSSA14:
        raise NotImplementedError(
            f"BooreEtAl2014 built-in supports PGA/PGV; {imt} requires openquake")
    cf = _BSSA14[key]
    mech = _bssa14_mech(rake)
    ln_y = _bssa14_event_path(cf, mag, rjb, mech)
    pga_r = np.exp(_bssa14_event_path(_BSSA14["PGA"], mag, rjb, mech))
    ln_flin = cf["c"] * np.log(min(vs30, cf["Vc"]) / _BSSA14_VREF)
    f2 = cf["f4"] * (np.exp(cf["f5"] * (min(vs30, 760.0) - 360.0)) - np.exp(cf["f5"] * 400.0))
    ln_fnl = _BSSA14_F1 + f2 * np.log((pga_r + _BSSA14_F3) / _BSSA14_F3)
    return np.exp(ln_y + ln_flin + ln_fnl)


def epri_epicentral_to_rjb(repi, mag: float, *, C1=-2.118, C2=0.17, C3=-0.14, C4=1.19,
                           C5=0.09):
    """The EPRI (2003) empirical epicentral -> Joyner-Boore distance adjustment."""
    repi = np.asarray(repi, np.float64)
    h = np.exp(C4 + C5 * (mag - 6.0))
    rprime = np.sqrt(repi**2 + h**2)
    return repi * (1 - 1 / np.cosh(C1 + C2 * (mag - 6.0) + C3 * np.log(rprime)))


# log10 corrections of the Kanno2006 medians from vectorial peaks to the
# geometric means the residual workflow compares
KANNO_MEAN_CONVENTION_LOG10 = {"PGA": -0.07, "PGV": -0.11}


def gmm_curve(imt: str, mag: float, distances, vs30: float = 400.0,
              model: str = "Kanno2006Shallow", *, rake: float | None = None,
              mean_convention_correction: bool = False):
    """A ground-motion prediction curve: hypocentral/rupture distances for
    Kanno2006, Joyner-Boore for BooreEtAl2014; PGA in cm/s^2, PGV in cm/s.
    OpenQuake when importable, else the built-in forms."""
    key = imt.upper()
    try:
        curve = _gmm_curve_openquake(key, mag, distances, vs30, model, rake)
    except ImportError:
        if model == "Kanno2006Shallow":
            curve = kanno2006_shallow(key, mag, distances, vs30)
        elif model == "BooreEtAl2014":
            curve = boore_etal_2014(key, mag, distances, vs30, rake)
            if key == "PGA":
                curve = curve * 980.665  # g -> cm/s^2
        else:
            raise NotImplementedError(
                f"unknown GMM {model!r}; built-ins: Kanno2006Shallow, BooreEtAl2014") from None
    if mean_convention_correction and model.startswith("Kanno") and key in (
            KANNO_MEAN_CONVENTION_LOG10):
        curve = curve * 10.0 ** KANNO_MEAN_CONVENTION_LOG10[key]
    return curve


def _gmm_curve_openquake(imt, mag, distances, vs30, model, rake):
    """Median curve through OpenQuake's point API."""
    from openquake.hazardlib import contexts as oq_ctx
    from openquake.hazardlib import imt as oq_imt
    from openquake.hazardlib.valid import gsim as oq_gsim

    gmpe = oq_gsim(model)
    distances = np.asarray(distances, np.float64)
    ctx = oq_ctx.RuptureContext()
    ctx.mag = mag
    ctx.rake = rake if rake is not None else 0.0
    ctx.hypo_depth = 15.0
    ctx.sids = np.arange(len(distances))
    ctx.vs30 = np.full(len(distances), vs30)
    ctx.vs30measured = np.ones(len(distances), bool)
    ctx.rjb = distances
    ctx.rrup = distances
    ctx.rhypo = distances
    im = oq_imt.from_string(imt if imt.startswith("SA") else imt.upper())
    mean = np.zeros((1, len(distances)))
    sig = tau = phi = np.zeros_like(mean)
    gmpe.compute(ctx, [im], mean, sig, tau, phi)
    out = np.exp(mean[0])
    if imt.upper() == "PGA" or imt.startswith("SA"):
        out = out * 980.665  # g -> cm/s^2
    return out
