"""Evaluation figures: the port of ``tqdne_tpu/eval/plots.py``, matplotlib
(Agg) over numpy, as in the JAX package.  Every figure takes channel-first
(B, C, T) waveform batches as arrays or tensors (a tensor is copied to the
host at entry) and returns a matplotlib figure:

- ``SamplePlot``: a few predicted (and target) traces;
- ``UpsamplingSamplePlot``: the input, target and reconstruction of a
  signal-to-signal task;
- ``AmplitudeSpectralDensityPlot``: mean +/- std log-ASD, predicted against target;
- ``BinPlot``: a metric's heatmap over magnitude x distance bins;
- ``MovingAverageEnvelopeGrid`` / ``AmplitudeSpectralDensityGrid``: one row
  per distance bin, one line per magnitude bin, predicted beside target;
- ``WaveformGalleryGrid``: each observed event beside K conditioned samples;
- ``CumulativeProbabilityPlot``: the likelihood of the observations under
  the generated IM distribution (``lognormal_likelihood_matrix``), and
  under a GMM with their ratio.

Importing this module imports matplotlib.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tqdne_tpu_torch.data.representation import moving_average_same  # noqa: E402
from tqdne_tpu_torch.eval.metrics import Metric  # noqa: E402

# Okabe-Ito colourblind-safe roles, fixed across all figures
C_PRED = "#0072b2"  # generated / predicted
C_TARGET = "#d55e00"  # observed / target
C_INPUT = "#009e73"  # conditioning input signal


def host(x):
    """An array, or a tensor copied to the host as one; None stays None."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return None if x is None else np.asarray(x)


def fig_to_image(fig):
    """A matplotlib figure rendered to a PIL image, for image-based metric sinks."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
    buf.seek(0)
    return Image.open(buf).convert("RGB")


# ---------------------------------------------------------------- primitives


def overlay_traces(ax, x, series, alpha=0.75):
    """Labelled line overlays; ``series`` holds (label, y, colour) tuples, a
    None y skipped."""
    for label, y, color in series:
        if y is not None:
            ax.plot(x, y, color=color, label=label, alpha=alpha, linewidth=0.9)


def band(ax, x, samples, color, label):
    """Mean line and one-sigma shading of a (B, X) sample set; with
    color=None the axis' property cycle picks it (the shading matches)."""
    mean = samples.mean(axis=0)
    spread = samples.std(axis=0)
    (line,) = ax.plot(x, mean, color=color, label=label)
    ax.fill_between(x, mean - spread, mean + spread, color=line.get_color(), alpha=0.18,
                    linewidth=0)


def binned_rows(mag, dist, mag_bins, dist_bins, min_count=2):
    """Yield (i_dist, j_mag, mask, label) for every populated bin."""
    mag, dist = np.asarray(mag), np.asarray(dist)
    for i in range(len(dist_bins) - 1):
        in_dist = (dist >= dist_bins[i]) & (dist < dist_bins[i + 1])
        for j in range(len(mag_bins) - 1):
            mask = in_dist & (mag >= mag_bins[j]) & (mag < mag_bins[j + 1])
            if mask.sum() >= min_count:
                yield i, j, mask, f"M {mag_bins[j]}-{mag_bins[j + 1]}"


def log_asd(signal, log_eps=1e-8):
    """Log amplitude spectral density along the last axis."""
    return np.log(np.clip(np.abs(np.fft.rfft(signal, axis=-1)), log_eps, None))


def _slice_channel(arr, channel):
    if arr is None or channel is None:
        return arr
    return arr[:, channel]


# ------------------------------------------------------------------- classes


class Plot(ABC):
    """A named figure builder over (pred, target, cond_signal, aux...)
    batches; subclasses implement ``render`` on channel-sliced arrays."""

    def __init__(self, channel: int | None = None):
        self.channel = channel

    @property
    def name(self) -> str:
        base = type(self).__name__
        if self.channel is None:
            return base
        return f"{base} - Channel {self.channel}"

    def __call__(self, pred, target=None, cond_signal=None, **aux):
        pred = _slice_channel(host(pred), self.channel)
        target = _slice_channel(host(target), self.channel)
        cond_signal = _slice_channel(host(cond_signal), self.channel)
        aux = {k: host(v) for k, v in aux.items()}
        return self.render(pred, target, cond_signal, **aux)

    @abstractmethod
    def render(self, pred, target, cond_signal, **aux):
        ...

    def plot(self, pred, target=None, cond_signal=None, **aux):
        """``render`` under the JAX package's older method name."""
        return self.render(pred, target, cond_signal, **aux)


class SamplePlot(Plot):
    """Stacked generated traces, optionally overlaid with their targets."""

    def __init__(self, plot_target: bool = False, fs: float = 100, channel: int = 0, n: int = 5):
        super().__init__(channel)
        self.plot_target = plot_target
        self.fs = fs
        self.n = n

    def render(self, pred, target, cond_signal, **aux):
        rows = min(self.n, len(pred))
        seconds = np.arange(pred.shape[-1]) / self.fs
        fig, axes = plt.subplots(rows, 1, figsize=(12, 2.4 * rows), sharex=True, squeeze=False)
        for i in range(rows):
            ax = axes[i, 0]
            wanted = [("Target", target[i] if self.plot_target and target is not None else None,
                       C_TARGET),
                      ("Predicted", pred[i], C_PRED)]
            overlay_traces(ax, seconds, wanted)
            ax.set_ylabel("Amplitude")
            ax.grid(True, alpha=0.3)
            if i == 0:
                ax.legend(loc="upper right")
        axes[-1, 0].set_xlabel("Time [s]")
        fig.tight_layout()
        plt.close(fig)
        return fig


class UpsamplingSamplePlot(Plot):
    """One-axis overlay of the conditioning input, the target and the
    reconstruction of a signal-to-signal task."""

    def __init__(self, fs: float = 100, channel: int = 0):
        super().__init__(channel)
        self.fs = fs

    def render(self, pred, target, cond_signal, **aux):
        seconds = np.arange(pred.shape[-1]) / self.fs
        fig, ax = plt.subplots(figsize=(12, 4.5))
        overlay_traces(ax, seconds, [
            ("Input", cond_signal[0] if cond_signal is not None else None, C_INPUT),
            ("Target", target[0] if target is not None else None, C_TARGET),
            ("Predicted", pred[0], C_PRED),
        ])
        ax.set_xlabel("Time [s]")
        ax.set_ylabel("Amplitude")
        ax.grid(True, alpha=0.3)
        ax.legend()
        fig.tight_layout()
        plt.close(fig)
        return fig


class AmplitudeSpectralDensityPlot(Plot):
    """Mean +/- std of log amplitude spectral densities, predicted against target."""

    def __init__(self, fs: float, channel: int = 0, log_eps: float = 1e-8):
        super().__init__(channel)
        self.fs = fs
        self.log_eps = log_eps

    def render(self, pred, target, cond_signal, **aux):
        freq = np.fft.rfftfreq(pred.shape[-1], d=1 / self.fs)
        with np.errstate(divide="ignore"):
            lf = np.log(freq)
        fig, ax = plt.subplots(figsize=(10, 5))
        band(ax, lf, log_asd(pred, self.log_eps), C_PRED, "Predicted")
        if target is not None:
            band(ax, lf, log_asd(target, self.log_eps), C_TARGET, "Target")
        ax.set_xlabel("Log-Frequency [Hz]")
        ax.set_ylabel(r"Log-Amplitude $[m/s^2\,Hz^{-1}]$")
        ax.grid(True, alpha=0.3)
        ax.legend()
        fig.tight_layout()
        plt.close(fig)
        return fig


class BinPlot(Plot):
    """Heatmap of a metric over magnitude x distance bins."""

    def __init__(self, metric: Metric, mag_bins, dist_bins, fmt: str = ".2f"):
        super().__init__(None)
        self.metric = metric
        self.mag_bins = list(mag_bins)
        self.dist_bins = list(dist_bins)
        self.fmt = fmt

    @property
    def name(self):
        return f"Bin {self.metric.name}"

    def render(self, pred, target, cond_signal, *, mag=None, dist=None, **aux):
        nd, nm = len(self.dist_bins) - 1, len(self.mag_bins) - 1
        cells = np.full((nd, nm), np.nan)
        for i, j, mask, _ in binned_rows(mag, dist, self.mag_bins, self.dist_bins):
            cells[i, j] = self.metric(pred[mask], target[mask])
        fig, ax = plt.subplots(figsize=(1.5 * nm + 2, 1.2 * nd + 2))
        im = ax.imshow(cells, cmap="viridis", origin="lower", aspect="auto")
        for (i, j), val in np.ndenumerate(cells):
            if np.isfinite(val):
                ax.text(j, i, format(val, self.fmt), ha="center", va="center", color="w",
                        fontsize=9)
        ax.set_xticks(np.arange(nm + 1) - 0.5, self.mag_bins)
        ax.set_yticks(np.arange(nd + 1) - 0.5, self.dist_bins)
        ax.set_xlabel("Magnitude bin")
        ax.set_ylabel("Distance bin [km]")
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        plt.close(fig)
        return fig


class GridPlot(Plot, ABC):
    """Predicted beside target: one row per distance bin, one line per
    magnitude bin, mean +/- std of a per-waveform transform."""

    def __init__(self, fs, channel, mag_bins, dist_bins):
        super().__init__(channel)
        self.fs = fs
        self.mag_bins = list(mag_bins)
        self.dist_bins = list(dist_bins)

    @abstractmethod
    def transform(self, waveform):
        ...

    @property
    @abstractmethod
    def xlabel(self):
        ...

    @property
    @abstractmethod
    def ylabel(self):
        ...

    @abstractmethod
    def xticks(self, length):
        ...

    def render(self, pred, target, cond_signal, *, mag=None, dist=None, **aux):
        nd = len(self.dist_bins) - 1
        fig, axs = plt.subplots(nd, 2, figsize=(14, 4 * nd), squeeze=False)
        xt = self.xticks(pred.shape[-1])
        for i, _, mask, label in binned_rows(mag, dist, self.mag_bins, self.dist_bins):
            for col, batch in enumerate((pred, target)):
                if batch is None:
                    continue
                band(axs[i, col], xt, self.transform(batch[mask]), color=None, label=label)
        for i in range(nd):
            span = f"{self.dist_bins[i]}-{self.dist_bins[i + 1]} km"
            axs[i, 0].set_title(f"Predicted  ({span})")
            axs[i, 1].set_title(f"Target  ({span})")
            for ax in axs[i]:
                ax.set_xlabel(self.xlabel)
                ax.set_ylabel(self.ylabel)
                ax.grid(True)
        # one y-range for every panel
        flat = axs.flatten()
        lo = min(a.get_ylim()[0] for a in flat)
        hi = max(a.get_ylim()[1] for a in flat)
        for a in flat:
            a.set_ylim(lo, hi)
            a.margins(x=0)
        handles, labels = axs[0, 0].get_legend_handles_labels()
        if handles:
            fig.legend(handles, labels, loc="lower center", ncol=len(self.mag_bins) - 1,
                       title="Magnitude bins")
        fig.tight_layout()
        plt.close(fig)
        return fig


class MovingAverageEnvelopeGrid(GridPlot):
    def __init__(self, fs, channel, mag_bins, dist_bins, window_size=128, log_eps=1e-6):
        super().__init__(fs, channel, mag_bins, dist_bins)
        self.window_size = window_size
        self.log_eps = log_eps

    xlabel = property(lambda self: "Time [s]")
    ylabel = property(lambda self: r"Log-Amplitude $[m/s^2]$")

    def xticks(self, length):
        return np.arange(length) / self.fs

    def transform(self, waveform):
        env = moving_average_same(torch.from_numpy(np.abs(waveform)), self.window_size)
        return np.log(env.numpy() + self.log_eps)


class AmplitudeSpectralDensityGrid(GridPlot):
    def __init__(self, fs, channel, mag_bins, dist_bins, log_eps=1e-8):
        super().__init__(fs, channel, mag_bins, dist_bins)
        self.log_eps = log_eps

    xlabel = property(lambda self: "Frequency [Hz]")
    ylabel = property(lambda self: r"Log-Amplitude $[m/s^2\,Hz^{-1}]$")

    def xticks(self, length):
        return np.fft.rfftfreq(length, d=1 / self.fs)

    def transform(self, waveform):
        return log_asd(waveform, self.log_eps)


class WaveformGalleryGrid(Plot):
    """Observed events beside K conditioned samples each, every trace
    normalised to its own peak, the peak written on the right."""

    def __init__(self, fs: float = 100, channel: int = 0, samples_per_event: int = 6):
        super().__init__(channel)
        self.fs = fs
        self.samples_per_event = samples_per_event

    def render(self, pred, target, cond_signal, *, event_labels=None, **aux):
        """``pred``: (n_events * samples_per_event, T) generated traces grouped
        by event; ``target``: (n_events, T) observed traces."""
        k = self.samples_per_event
        n_events = len(target)
        seconds = np.arange(target.shape[-1]) / self.fs
        fig, axes = plt.subplots(1, n_events, figsize=(6 * n_events, 1.1 * (k + 1) + 1),
                                 squeeze=False)
        for e in range(n_events):
            ax = axes[0, e]
            traces = [(target[e], C_TARGET)] + [
                (pred[e * k + s], C_PRED) for s in range(min(k, len(pred) - e * k))]
            for row, (tr, color) in enumerate(traces):
                peak = np.max(np.abs(tr)) or 1.0
                ax.plot(seconds, tr / peak * 0.45 - row, color=color, linewidth=0.6)
                ax.text(seconds[-1], -row, f" {peak:.3g}", fontsize=7, va="center")
            ax.set_yticks([0], ["obs"])
            ax.set_ylim(-len(traces) + 0.4, 0.6)
            ax.set_xlabel("Time [s]")
            if event_labels is not None:
                ax.set_title(str(np.asarray(event_labels)[e]), fontsize=10)
        axes[0, 0].set_ylabel("normalized traces")
        fig.tight_layout()
        plt.close(fig)
        return fig


def lognormal_likelihood_matrix(obs_im, gen_im, mag, dist, mag_bins, dist_bins, gen_mag=None,
                                gen_dist=None, min_count=3):
    """The mean likelihood of the observed intensity measures under the
    generated distribution, per magnitude x distance bin: a lognormal fitted
    to each bin's generated IMs (median from the 50th percentile, sigma from
    (ln p84 - ln p16) / 2) averaged over the bin's observed IMs.  Returns
    (n_mag_bins - 1, n_dist_bins - 1), NaN where either set is too small."""
    obs_im, gen_im, mag, dist = map(host, (obs_im, gen_im, mag, dist))
    gen_mag = mag if gen_mag is None else host(gen_mag)
    gen_dist = dist if gen_dist is None else host(gen_dist)
    out = np.full((len(mag_bins) - 1, len(dist_bins) - 1), np.nan)
    for j in range(len(mag_bins) - 1):
        o_m = (mag >= mag_bins[j]) & (mag < mag_bins[j + 1])
        g_m = (gen_mag >= mag_bins[j]) & (gen_mag < mag_bins[j + 1])
        for i in range(len(dist_bins) - 1):
            o = o_m & (dist >= dist_bins[i]) & (dist < dist_bins[i + 1]) & (obs_im > 0)
            g = g_m & (gen_dist >= dist_bins[i]) & (gen_dist < dist_bins[i + 1]) & (gen_im > 0)
            if o.sum() < 1 or g.sum() < min_count:
                continue
            p16, p50, p84 = np.percentile(np.log(gen_im[g]), [16, 50, 84])
            sigma = max((p84 - p16) / 2, 1e-6)
            z = (np.log(obs_im[o]) - p50) / sigma
            pdf = np.exp(-0.5 * z**2) / (sigma * np.sqrt(2 * np.pi))
            out[j, i] = float(pdf.mean())
    return out


class CumulativeProbabilityPlot(Plot):
    """Heatmaps of the observations' likelihood under the generated IM
    distribution and, with a GMM matrix, under the GMM and their ratio."""

    def __init__(self, mag_bins, dist_bins, im_name: str = "PGA"):
        super().__init__(None)
        self.mag_bins = list(mag_bins)
        self.dist_bins = list(dist_bins)
        self.im_name = im_name

    def render(self, pred, target, cond_signal, *, mag=None, dist=None, gmm_matrix=None, **aux):
        """``pred`` / ``target``: generated / observed scalar IMs (B,)."""
        gwm = lognormal_likelihood_matrix(target, pred, mag, dist, self.mag_bins, self.dist_bins)
        panels = [("GWM", gwm)]
        if gmm_matrix is not None:
            panels = [("GMM", gmm_matrix), ("GWM", gwm), ("GMM / GWM ratio", gmm_matrix / gwm)]
        fig, axes = plt.subplots(len(panels), 1, figsize=(8, 3.6 * len(panels)), squeeze=False)
        finite = np.concatenate([p[1][np.isfinite(p[1])] for p in panels[:2]]) if len(
            panels) > 1 else gwm[np.isfinite(gwm)]
        vmax = finite.max() if finite.size else 1.0
        for ax, (title, mat) in zip(axes[:, 0], panels):
            is_ratio = "ratio" in title
            im = ax.imshow(mat, origin="lower", cmap="plasma", aspect="auto",
                           vmin=None if is_ratio else 0.0, vmax=None if is_ratio else vmax)
            ax.set_title(f"{title}: {self.im_name} likelihood")
            ax.set_ylabel("Magnitude bin")
            ax.set_yticks(np.arange(len(self.mag_bins)) - 0.5, self.mag_bins)
            ax.set_xticks(np.arange(len(self.dist_bins)) - 0.5, [f"{d:g}" for d in self.dist_bins])
            fig.colorbar(im, ax=ax, label="mean likelihood")
        axes[-1, 0].set_xlabel("Distance bin [km]")
        fig.tight_layout()
        plt.close(fig)
        return fig
