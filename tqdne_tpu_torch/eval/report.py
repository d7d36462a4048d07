"""Evaluation report: the port of ``tqdne_tpu/eval/report.py``
(``evaluation_report``, ``report_figures`` and ``main``).

``evaluation_report`` reads the HDF5 files ``cli.evaluate`` writes (one per
rank) and hands their arrays to ``report_from_arrays``, which computes every
statistic:

- FID between predicted and target classifier embeddings (plus a
  calibration FID against a second set of target embeddings, e.g. the train
  split's), and the Inception Score of the predicted logits;
- the classifier's accuracy on the magnitude x distance bins;
- ASD Frechet distance and MSE per channel;
- per-bin matrices of FID, accuracy and ASD.

``report_from_arrays`` needs no HDF5, so callers that hold the arrays in
memory (the GPU smoke run) take the same code.  ``report_figures`` renders
the figure set of ``eval.plots`` (matplotlib) from the same files.

    python -m tqdne_tpu_torch.eval.report evaluation/*-rank_0.h5 [--out report.json] \
        [--figures DIR]
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tqdne_tpu_torch.configs import DIST_BINS, MAG_BINS
from tqdne_tpu_torch.eval.metrics import (AmplitudeSpectralDensity, MeanSquaredError,
                                          frechet_distance, inception_score)

CLASSIFIER_KEYS = ("predicted_classifier_embedding", "target_classifier_embedding",
                   "predicted_classifier_pred", "target_classifier_pred")
REPORT_KEYS = ("predicted_waveform", "target_waveform", "magnitude", "hypocentral_distance")


def _paths(files) -> list[Path]:
    return [Path(p) for p in (files if isinstance(files, (list, tuple)) else [files])]


def _concat_ranks(paths: list[Path], key: str) -> np.ndarray:
    import h5py

    parts = []
    for p in paths:
        with h5py.File(p, "r") as f:
            parts.append(f[key][()])
    return np.concatenate(parts)


def read_eval_files(eval_files, keys=None) -> tuple[dict, dict | None]:
    """(arrays, provenance) of evaluate output files: the datasets ``keys``
    (by default those the report reads: ``REPORT_KEYS``, and the
    ``CLASSIFIER_KEYS`` where a classifier ran), concatenated over the files
    in order, and their common provenance (or, where the files differ, each
    file's under ``mixed``)."""
    import h5py

    paths = _paths(eval_files)
    provs = []
    for i, p in enumerate(paths):
        with h5py.File(p, "r") as f:
            if i == 0 and keys is None:
                keys = REPORT_KEYS + (CLASSIFIER_KEYS if "predicted_classifier_embedding" in f
                                      else ())
            provs.append(json.loads(f.attrs["provenance"])
                         if "provenance" in f.attrs else None)
    arrays = {key: _concat_ranks(paths, key) for key in keys}
    # merged inputs (rank files, --suffix sweeps) must agree on what they
    # evaluated; labelling the report with the first file's provenance would
    # misattribute the other files' samples
    if all(pv == provs[0] for pv in provs):
        return arrays, provs[0]
    return arrays, {
        "mixed": provs,
        "note": "input files carry differing provenance; see 'mixed' "
                "(one entry per input file, in argument order)",
    }


def _bin_label(mag, dist, mag_bins, dist_bins):
    return (np.digitize(dist, dist_bins) - 1) * (len(mag_bins) - 1) + np.digitize(
        mag, mag_bins
    ) - 1


def _json_safe(x):  # NaN -> None so the output is strict JSON
    if isinstance(x, float) and not np.isfinite(x):
        return None
    if isinstance(x, list):
        return [_json_safe(v) for v in x]
    return x


def report_from_arrays(arrays: dict, mag_bins=MAG_BINS, dist_bins=DIST_BINS, fs: float = 100.0,
                       min_bin_count: int = 8, calibration_embedding=None,
                       provenance: dict | None = None) -> dict:
    """Every statistic of the report from ``arrays``: ``predicted_waveform``
    and ``target_waveform`` (N, C, T), ``magnitude`` and
    ``hypocentral_distance`` (N,), and, where a classifier ran, the
    ``CLASSIFIER_KEYS`` embeddings (N, E) and logits (N, K).
    ``calibration_embedding``: another set's target embeddings, for the
    calibration FID."""
    pred_wf, targ_wf = arrays["predicted_waveform"], arrays["target_waveform"]
    mag, dist = arrays["magnitude"], arrays["hypocentral_distance"]
    has_classifier = "predicted_classifier_embedding" in arrays

    report: dict = {"num_samples": int(len(pred_wf))}
    if provenance is not None:
        report["provenance"] = provenance
    labels = _bin_label(mag, dist, list(mag_bins), list(dist_bins))

    if has_classifier:
        pred_emb, targ_emb, pred_logits, targ_logits = (arrays[k] for k in CLASSIFIER_KEYS)

        # global FID / IS
        report["fid"] = frechet_distance(pred_emb, targ_emb)
        if calibration_embedding is not None:
            report["fid_calibration"] = frechet_distance(calibration_embedding, targ_emb)
        report["inception_score"] = inception_score(pred_logits)

        # classifier accuracy vs the conditioning bins
        report["classifier_accuracy_target"] = float((targ_logits.argmax(-1) == labels).mean())
        report["classifier_accuracy_predicted"] = float(
            (pred_logits.argmax(-1) == labels).mean())
    else:
        report["fid"] = None
        report["inception_score"] = None

    # ASD Frechet + MSE per channel
    n_ch = pred_wf.shape[1]
    report["asd_frechet_per_channel"] = [
        AmplitudeSpectralDensity(fs=fs, channel=c, isotropic=True)(pred_wf, targ_wf)
        for c in range(n_ch)
    ]
    report["mse_per_channel"] = [MeanSquaredError(c)(pred_wf, targ_wf) for c in range(n_ch)]

    # per-bin matrices: FID + accuracy (classifier) and ASD Frechet
    nd, nm = len(dist_bins) - 1, len(mag_bins) - 1
    fid_bins = np.full((nd, nm), np.nan)
    acc_bins = np.full((nd, nm), np.nan)
    asd_bins = np.full((nd, nm), np.nan)
    asd0 = AmplitudeSpectralDensity(fs=fs, channel=0, isotropic=True)
    for i in range(nd):
        for j in range(nm):
            m = (
                (dist >= dist_bins[i]) & (dist < dist_bins[i + 1])
                & (mag >= mag_bins[j]) & (mag < mag_bins[j + 1])
            )
            if m.sum() >= min_bin_count:
                asd_bins[i, j] = asd0(pred_wf[m], targ_wf[m])
                if has_classifier:
                    fid_bins[i, j] = frechet_distance(pred_emb[m], targ_emb[m], isotropic=True)
                    acc_bins[i, j] = float((pred_logits[m].argmax(-1) == labels[m]).mean())

    report["fid_per_bin"] = _json_safe(fid_bins.tolist())
    report["accuracy_per_bin"] = _json_safe(acc_bins.tolist())
    report["asd_frechet_per_bin"] = _json_safe(asd_bins.tolist())
    report["mag_bins"] = list(mag_bins)
    report["dist_bins"] = list(dist_bins)
    return report


def evaluation_report(eval_files, mag_bins=MAG_BINS, dist_bins=DIST_BINS, fs: float = 100.0,
                      min_bin_count: int = 8, calibration_files=None) -> dict:
    """The report over evaluate output files.  ``calibration_files``: a second
    evaluate output set (e.g. the TRAIN split) whose target embeddings are
    compared against this set's: the train-vs-test FID baseline."""
    arrays, provenance = read_eval_files(eval_files)
    calibration = (_concat_ranks(_paths(calibration_files), "target_classifier_embedding")
                   if calibration_files and "predicted_classifier_embedding" in arrays else None)
    return report_from_arrays(arrays, mag_bins, dist_bins, fs, min_bin_count,
                              calibration_embedding=calibration, provenance=provenance)


def report_figures(eval_files, outdir, mag_bins=MAG_BINS, dist_bins=DIST_BINS, fs: float = 100.0,
                   gallery_events: int = 3, gallery_samples: int = 5) -> list[Path]:
    """Render the figure set of the evaluate outputs into ``outdir``: the ASD
    comparison, a sample overlay, the envelope and ASD grids, the per-bin
    ASD heatmap, the waveform gallery (each picked event beside the rows of
    nearest conditioning) and the PGA likelihood heatmap.  Returns the PNG
    paths, in that order."""
    from tqdne_tpu_torch.eval import plots as P

    arrays, _ = read_eval_files(eval_files, keys=REPORT_KEYS)
    pred_wf, targ_wf = arrays["predicted_waveform"], arrays["target_waveform"]
    mag, dist = arrays["magnitude"], arrays["hypocentral_distance"]
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    mb, db = list(mag_bins), list(dist_bins)

    figures = {
        "asd_comparison": P.AmplitudeSpectralDensityPlot(fs=fs, channel=0),
        "sample_overlay": P.SamplePlot(plot_target=True, fs=fs, channel=0, n=4),
        "envelope_grid": P.MovingAverageEnvelopeGrid(fs, 0, mb, db),
        "asd_grid": P.AmplitudeSpectralDensityGrid(fs, 0, mb, db),
        "bin_asd": P.BinPlot(AmplitudeSpectralDensity(fs=fs, channel=0, isotropic=True), mb, db),
    }
    written = []

    def save(fig, name):
        path = outdir / f"{name}.png"
        fig.savefig(path, dpi=110, bbox_inches="tight")
        written.append(path)

    for name, plot in figures.items():
        binned = isinstance(plot, (P.BinPlot, P.GridPlot))
        save(plot(pred_wf, targ_wf, **({"mag": mag, "dist": dist} if binned else {})), name)

    # gallery: for each picked event, the generated rows of the nearest conditioning
    # (each evaluate row has exactly one sample per conditioning)
    order = np.argsort(mag)
    picks = order[np.linspace(0, len(order) - 1, gallery_events).astype(int)]
    gal_pred, labels = [], []
    for e in picks:
        score = (np.abs(mag - mag[e]) / 0.5) ** 2 + (np.abs(dist - dist[e]) / 20.0) ** 2
        gal_pred.append(pred_wf[np.argsort(score)[1: gallery_samples + 1]])
        labels.append(f"M{mag[e]:.1f}  {dist[e]:.0f} km")
    save(P.WaveformGalleryGrid(fs=fs, channel=0, samples_per_event=gallery_samples)(
        np.concatenate(gal_pred), targ_wf[picks], event_labels=labels), "waveform_gallery")

    # the PGA likelihood heatmap over the horizontals' peaks
    def pga(wf):
        return np.abs(wf[:, :2]).max(axis=(1, 2))

    save(P.CumulativeProbabilityPlot(mb, db, im_name="PGA")(pga(pred_wf), pga(targ_wf), mag=mag,
                                                             dist=dist), "cumulative_probability")
    return written


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser("tqdne_tpu_torch.eval.report",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("files", nargs="+", help="cli.evaluate output HDF5 files")
    parser.add_argument("--out", type=str, default=None, help="JSON output path")
    parser.add_argument("--calibration-files", nargs="+", default=None,
                        help="second evaluate-output set (train split) for the "
                             "train-vs-test calibration FID")
    parser.add_argument("--figures", type=str, default=None,
                        help="also render the figure set into this directory (matplotlib)")
    args = parser.parse_args(argv)
    report = evaluation_report(args.files, calibration_files=args.calibration_files)
    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    if args.figures:
        for p in report_figures(args.files, args.figures):
            print(f"wrote {p}")


if __name__ == "__main__":
    main()
