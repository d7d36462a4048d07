"""Waveform datasets: the port of ``Dataset``, ``CachedLatentsDataset``,
``ClassificationDataset``, ``PairedDataset``, ``split_indices``,
``_row_gather`` and ``make_synthetic_dataset`` in ``tqdne_tpu/data/dataset.py``.

Storage contract of ``preprocessed_waveforms.h5``: ``waveforms`` (N, 3, T)
float32, ``normalized_features`` (N, 5) float32, ``indices_valid_waveforms``
(N,) and one raw array per conditioning feature.  The split is the
reference's: a seed-42 numpy permutation, 85/5/10 train/validation/test,
plus "train_validation" and "full".

Batches are read as sorted slabs and the representation is applied to the
whole batch on the host.  Every dataset reads either an HDF5 file (a path)
or the same columns held in memory (a dict of arrays, as
``synthetic_arrays`` returns); ``h5py`` is imported only where a file is
opened, so the in-memory form works where ``h5py`` is not installed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

FEATURE_NAMES = ("hypocentral_distance", "magnitude", "vs30", "hypocentre_depth",
                 "azimuthal_gap")


def split_indices(n: int, split: str, seed: int = 42) -> np.ndarray:
    indices = np.arange(n)
    shuffled = np.random.default_rng(seed=seed).permutation(indices)
    n_train = int(n * 0.85)
    n_val = int(n * 0.9)
    if split == "full":
        return indices
    if split == "train":
        return shuffled[:n_train]
    if split == "validation":
        return shuffled[n_train:n_val]
    if split == "train_validation":
        return shuffled[:n_val]
    if split == "test":
        return shuffled[n_val:]
    raise ValueError(f"Unknown split {split}")


def _row_gather(file_idx: np.ndarray):
    """Slab-read plan for arbitrary row indices: (uniq, restore) such that
    ``dset[uniq][restore]`` yields the rows in the requested order (h5py
    wants strictly increasing unique indices)."""
    order = np.argsort(file_idx)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    uniq, uinv = np.unique(file_idx[order], return_inverse=True)
    return uniq, uinv[inv]


def _open(source):
    """(table, file): a dict of arrays as it is, or an HDF5 file opened for reading."""
    if isinstance(source, dict):
        return source, None
    import h5py

    file = h5py.File(source, "r", locking=False)
    return file, file


class _Batches:
    """``load_batch`` and ``get_feature`` over a table with ``waveforms``,
    ``normalized_features``, ``indices_valid_waveforms`` and one column per
    raw feature (an HDF5 file or a dict of arrays), for the rows of a split."""

    def __init__(self, source, representation, cut: int | None = None, cond: bool = False,
                 split: str = "train"):
        self.representation = representation
        self.cut = cut
        self.use_conditioning = cond
        self.table, self.file = _open(source)
        self.waveforms = self.table["waveforms"]
        self.cond = self.table["normalized_features"] if cond else None
        self.valid = self.table["indices_valid_waveforms"]
        self.indices = split_indices(len(self.waveforms), split)

    def __len__(self) -> int:
        return len(self.indices)

    def close(self):
        if self.file is not None:
            self.file.close()

    def get_feature(self, key: str) -> np.ndarray:
        """A raw conditioning feature (e.g. ``magnitude``) over the split."""
        return np.asarray(self.table[key][:])[self.indices]

    def load_batch(self, batch_indices: np.ndarray, keys: tuple[str, ...] | None = None) -> dict:
        """A batch (split-relative indices) as a dict of numpy arrays.

        Rows are read in sorted order and put back in the requested one; the
        representation runs once over the batch.  ``keys`` selects what is
        materialised: without "waveform" and "signal" no waveform is read.
        """
        want = keys.__contains__ if keys is not None else (lambda k: True)
        uniq, restore = _row_gather(self.indices[batch_indices])
        out: dict = {}
        if want("waveform") or want("signal"):
            waveforms = self.waveforms[uniq][restore]
            if self.cut:
                waveforms = waveforms[:, :, : self.cut]
            if want("waveform"):
                out["waveform"] = waveforms.astype(np.float32)
            if want("signal"):
                signal = self.representation.get_representation(torch.from_numpy(
                    np.ascontiguousarray(waveforms, dtype=np.float32)))
                out["signal"] = signal.numpy().astype(np.float32, copy=False)
        if want("valid_index"):
            out["valid_index"] = np.asarray(self.valid[uniq][restore], dtype=np.int32)
        if self.use_conditioning and want("cond"):
            out["cond"] = self.cond[uniq][restore].astype(np.float32)
        return out


class Dataset(_Batches):
    """Seismic waveform dataset over ``preprocessed_waveforms.h5``."""

    def __init__(self, datapath: str | Path, representation, cut: int | None = None,
                 cond: bool = False, split: str = "train"):
        super().__init__(Path(datapath), representation, cut, cond, split)


class ArrayDataset(_Batches):
    """``Dataset`` over in-memory arrays (the dict ``synthetic_arrays``
    returns), for machines without ``h5py``."""

    def __init__(self, arrays: dict, representation, cut: int | None = None, cond: bool = False,
                 split: str = "train"):
        super().__init__(arrays, representation, cut, cond, split)


class CachedLatentsDataset(_Batches):
    """A dataset whose batches carry the frozen autoencoder's precomputed
    latent moments (``latent_mean``, ``latent_log_std``; written by
    ``cli.precompute_latents``) beside the conditioning.  Rows of the
    latents align with the dataset's storage order, so one split indexes
    both; a latents table of another row count is refused."""

    def __init__(self, source, latents, representation, *, cut: int | None = None,
                 cond: bool = True, split: str = "train"):
        super().__init__(source, representation, cut, cond, split)
        self.latents, self.latents_file = _open(latents)
        n_lat, n_wf = self.latents["latent_mean"].shape[0], self.waveforms.shape[0]
        if n_lat != n_wf:
            self.close()
            raise ValueError(f"latents file has {n_lat} rows but the dataset has {n_wf} — "
                             "re-run precompute_latents after rebuilding the dataset")

    def close(self):
        super().close()
        if getattr(self, "latents_file", None) is not None:
            self.latents_file.close()

    def load_batch(self, batch_indices: np.ndarray, keys: tuple[str, ...] | None = None) -> dict:
        out = super().load_batch(batch_indices, keys)
        uniq, restore = _row_gather(self.indices[batch_indices])
        for key in ("latent_mean", "latent_log_std"):
            if keys is None or key in keys:
                out[key] = np.asarray(self.latents[key][uniq][restore], np.float32)
        return out


class ClassificationDataset(_Batches):
    """Magnitude x distance bin labels: label = dist_bin * (n_mag_bins - 1)
    + mag_bin, with ``np.digitize`` over the raw features."""

    def __init__(self, source, representation, mag_bins, dist_bins, cut: int | None = None,
                 split: str = "train"):
        super().__init__(source, representation, cut, False, split)
        dist = np.asarray(self.table["hypocentral_distance"][:])
        mag = np.asarray(self.table["magnitude"][:])
        self.labels = ((np.digitize(dist, dist_bins) - 1) * (len(mag_bins) - 1)
                       + np.digitize(mag, mag_bins) - 1)
        self.num_classes = (len(mag_bins) - 1) * (len(dist_bins) - 1)

    def get_class_weights(self) -> np.ndarray:
        """Inverse-frequency class weights over the whole table, as the JAX
        package takes them."""
        return np.array([1.0 / max((self.labels == c).sum(), 1) for c in range(self.num_classes)],
                        dtype=np.float32)

    def load_batch(self, batch_indices: np.ndarray, keys: tuple[str, ...] | None = None) -> dict:
        out = super().load_batch(batch_indices, keys)
        if keys is None or "label" in keys:
            out["label"] = self.labels[self.indices[batch_indices]].astype(np.int32)
        return out


class PairedDataset:
    """Paired observed/synthetic waveforms for signal-to-signal tasks
    (upsampling, simulation enhancement): ``obs`` and ``syn``, each an HDF5
    file or a dict of arrays with ``waveforms`` (N, C, T) and optional
    per-trace ``snr`` (N, C) and ``data_ratio`` (N,).

    Rows are kept where every channel's SNR exceeds ``snr_min`` and the data
    ratio is under ``ratio_max`` in both tables, over their first
    min(N_obs, N_syn) rows; a seed-42 permutation of the kept rows gives the
    first 90% to training and the rest to ``training=False``.  Batches hold
    ``waveform`` and ``cond_waveform`` (the observed and synthetic records,
    cut to ``cut`` samples and zero-padded to it, NaNs as 0) and their
    representations ``signal`` and ``cond_signal``, all channels-first.
    ``load_batch`` returns the rows in storage order, not in the order asked,
    as the JAX class does."""

    def __init__(self, obs, syn, representation, cut: int | None = None, training: bool = True,
                 snr_min: float = 1.5, ratio_max: float = 10.0):
        self.representation = representation
        self.cut = cut
        self.obs, self.obs_file = _open(obs)
        self.syn, self.syn_file = _open(syn)
        n = min(len(self.obs["waveforms"]), len(self.syn["waveforms"]))
        mask = np.ones(n, bool)
        for table in (self.obs, self.syn):
            if "snr" in table:
                mask &= (np.asarray(table["snr"][:n]) > snr_min).all(axis=-1)
            if "data_ratio" in table:
                mask &= np.asarray(table["data_ratio"][:n]) < ratio_max
        indices = np.nonzero(mask)[0]
        shuffled = np.random.default_rng(seed=42).permutation(indices)
        n_train = int(len(indices) * 0.9)
        self.indices = shuffled[:n_train] if training else shuffled[n_train:]

    def __len__(self) -> int:
        return len(self.indices)

    def close(self):
        for file in (self.obs_file, self.syn_file):
            if file is not None:
                file.close()

    def _fit(self, x: np.ndarray) -> np.ndarray:
        if self.cut:
            x = x[..., : self.cut]
            if x.shape[-1] < self.cut:
                x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, self.cut - x.shape[-1])])
        return np.nan_to_num(x).astype(np.float32)

    def load_batch(self, batch_indices: np.ndarray, keys: tuple[str, ...] | None = None) -> dict:
        """The rows ``batch_indices`` (split-relative) in sorted order; ``keys``
        is accepted as the loaders pass it, and every column is read."""
        idx = np.sort(self.indices[batch_indices])
        obs = self._fit(self.obs["waveforms"][idx])
        syn = self._fit(self.syn["waveforms"][idx])

        def rep(x):
            return self.representation.get_representation(torch.from_numpy(x)).numpy() \
                .astype(np.float32, copy=False)

        return {"waveform": obs, "cond_waveform": syn, "signal": rep(obs), "cond_signal": rep(syn)}


def synthetic_arrays(n: int = 64, channels: int = 3, t: int = 4096, seed: int = 0) -> dict:
    """The arrays of ``make_synthetic_dataset``: waveforms with a real
    conditioning structure (physically inspired, not a simulation).

    - P onset near 5 s; S arrives dist * (1/3.5 - 1/6) s later;
    - log-amplitude ~ 0.8 mag - 1.2 log10(dist) + 0.4 log10(760 / vs30);
    - the corner frequency falls with magnitude and distance;
    - duration grows with magnitude and distance;
    - P is polarised to the vertical (last) channel, S to the horizontals.
    """
    from scipy import fft as sfft

    rng = np.random.default_rng(seed)
    fs = 100.0
    tt = np.arange(t, dtype=np.float32) / fs

    dist = rng.uniform(10, 200, n).astype(np.float32)
    mag = rng.uniform(4.5, 7.5, n).astype(np.float32)
    vs30 = rng.uniform(200, 800, n).astype(np.float32)
    depth = rng.uniform(2, 100, n).astype(np.float32)
    azgap = rng.uniform(30, 330, n).astype(np.float32)

    p_onset = 5.0 + rng.uniform(-1.0, 1.0, n).astype(np.float32)
    s_onset = p_onset + dist * np.float32(1 / 3.5 - 1 / 6.0)
    log_amp = 0.8 * (mag - 6.0) - 1.2 * np.log10(dist / 100.0) + 0.4 * np.log10(760.0 / vs30)
    amp = (10.0**log_amp).astype(np.float32)
    fc = (10.0 ** (1.1 - 0.3 * (mag - 4.5) - 0.2 * np.log10(dist / 30.0))).astype(np.float32)
    tau_p = (0.5 + 0.4 * (mag - 4.5)).astype(np.float32)
    tau_s = (1.5 + 1.2 * (mag - 4.5) + 0.015 * dist).astype(np.float32)

    def burst_envelope(onset, tau):  # Brune-like u exp(1 - u), zero before onset; (n, 1, t)
        u = np.maximum(tt[None, :] - onset[:, None], 0.0) / tau[:, None]
        return (u * np.exp(1.0 - u)).astype(np.float32)[:, None, :]

    freqs_r = np.fft.rfftfreq(t, d=1 / fs).astype(np.float32)

    def shaped_noise(fc_row, noise):  # 2-pole low-pass at fc, 0.1 Hz high-pass; (n, ch, t)
        spec = sfft.rfft(noise.astype(np.float32), axis=-1, workers=-1)
        lowpass = 1.0 / (1.0 + (freqs_r[None, None, :] / fc_row[:, None, None]) ** 2)
        highpass = (freqs_r[None, None, :] / 0.1) ** 2
        highpass = highpass / (1.0 + highpass)
        spec *= (lowpass * highpass).astype(np.float32)
        return sfft.irfft(spec, n=t, axis=-1, workers=-1).astype(np.float32)

    waveforms = np.empty((n, channels, t), np.float32)
    s_pol = np.ones(channels, np.float32)
    p_pol = np.full(channels, 0.3, np.float32)
    if channels >= 3:
        s_pol[-1], p_pol[-1] = 0.4, 1.0
    for s in range(0, n, 1024):  # chunked: the rfft of the whole array would take GBs
        e = min(s + 1024, n)
        p_wave = shaped_noise(2.5 * fc[s:e], rng.standard_normal((e - s, channels, t)))
        s_wave = shaped_noise(fc[s:e], rng.standard_normal((e - s, channels, t)))
        tr = (0.35 * p_pol[None, :, None] * burst_envelope(p_onset[s:e], tau_p[s:e]) * p_wave
              + s_pol[None, :, None] * burst_envelope(s_onset[s:e], tau_s[s:e]) * s_wave)
        rms = np.sqrt(np.mean(tr**2, axis=(1, 2), keepdims=True)) + 1e-12
        waveforms[s:e] = amp[s:e, None, None] * tr / rms
    waveforms += 0.002 * rng.standard_normal((n, channels, t)).astype(np.float32)

    feats = np.stack([dist, mag, vs30, depth, azgap], axis=1)
    norm_feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-8)
    return {
        "waveforms": waveforms,
        "normalized_features": norm_feats.astype(np.float32),
        "indices_valid_waveforms": np.full(n, t, dtype=np.int64),
        **dict(zip(FEATURE_NAMES, (dist, mag, vs30, depth, azgap))),
        "p_onset_s": p_onset,
        "s_onset_s": s_onset,
    }


def make_synthetic_dataset(path: str | Path, n: int = 64, channels: int = 3, t: int = 4096,
                           seed: int = 0) -> Path:
    """Write ``synthetic_arrays(n, channels, t, seed)`` as a
    ``preprocessed_waveforms.h5`` honouring the storage contract."""
    import h5py

    arrays = synthetic_arrays(n, channels, t, seed)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        for name, arr in arrays.items():
            f.create_dataset(name, data=arr)
    return path
