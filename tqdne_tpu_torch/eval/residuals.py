"""Ground-motion residuals, observed against generated PGA and PGV: the port
of ``tqdne_tpu/eval/residuals.py``.

The horizontals are integrated to velocity (or highpassed), their
rotation-invariant peaks taken on the device, and log10(obs / gen) binned by
hypocentral distance on the host, beside the Kanno (2006) and Boore et al.
(2014) median curves at the mean magnitude and vs30.  Over the HDF5 files of
``cli.evaluate``:

    python -m tqdne_tpu_torch.eval.residuals evaluation/*.h5 [--out r.json] \\
        [--plot r.png] [--n-bins 20] [--device cuda|cpu]
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tqdne_tpu_torch.eval import seismo
from tqdne_tpu_torch.utils import resolve_device


def residual_report(target_wf, predicted_wf, hypocentral_distance, *, dt: float = 0.01,
                    magnitude=None, vs30=None, n_bins: int = 20, device="cuda") -> dict:
    """PGA and PGV residual statistics (and the GMM curves when ``magnitude``
    and ``vs30`` are given).  The waveforms (N, C, T), arrays or tensors, go
    to ``device`` in float64 for the peaks; the statistics are numpy."""
    device = resolve_device(device)
    target = torch.as_tensor(target_wf, dtype=torch.float64, device=device)
    predicted = torch.as_tensor(predicted_wf, dtype=torch.float64, device=device)
    report: dict = {}
    for pgv, label in ((True, "PGV"), (False, "PGA")):
        res = seismo.evaluate_pgx(target, predicted, dt=dt, pgv=pgv)
        obs = res[f"{label}_geom_mean_obs"].cpu().numpy()
        gen = res[f"{label}_geom_mean_gwm"].cpu().numpy()
        binned = seismo.calculate_distance_binned_ratios(obs, gen, hypocentral_distance,
                                                         n_bins=n_bins)
        report[label] = {
            "bin_centers": binned["bin_centers"].tolist(),
            "median_log10_ratio": binned["median_ratios"].tolist(),
            "std_log10_ratio": binned["std_ratios"].tolist(),
            "bin_counts": binned["bin_counts"].tolist(),
            "global_median_log10_ratio": float(np.nanmedian(binned["ratio_values"])),
            "obs_peak_median": float(np.median(obs)),
            "gen_peak_median": float(np.median(gen)),
        }
        if magnitude is not None and vs30 is not None:
            mbar, vbar = float(np.mean(magnitude)), float(np.mean(vs30))
            centers = binned["bin_centers"]
            # Kanno2006Shallow on hypocentral distance with the geometric-mean
            # correction, BooreEtAl2014 on the EPRI-adjusted Joyner-Boore distance
            gmm = seismo.gmm_curve(label, mbar, centers, vbar, model="Kanno2006Shallow",
                                   mean_convention_correction=True)
            report[label]["gmm_kanno2006_median"] = np.asarray(gmm).tolist()
            rjb = seismo.epri_epicentral_to_rjb(centers, mbar)
            gmm_ba = seismo.gmm_curve(label, mbar, rjb, vbar, model="BooreEtAl2014", rake=0.0)
            report[label]["gmm_boore2014_median"] = np.asarray(gmm_ba).tolist()
    return report


def plot_residuals(report: dict, outpath=None):
    """Median log-ratio against distance, one panel per intensity measure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    for ax, label in zip(axes, ("PGV", "PGA")):
        d = report[label]
        centers = np.asarray(d["bin_centers"])
        med = np.asarray(d["median_log10_ratio"])
        std = np.asarray(d["std_log10_ratio"])
        ax.errorbar(centers, med, yerr=std, fmt="o-", capsize=3, label="median log10(obs/gen)")
        ax.axhline(0.0, color="k", lw=0.8, ls="--")
        ax.set_xlabel("Hypocentral distance [km]")
        ax.set_ylabel(f"log10({label}_obs / {label}_gen)")
        ax.set_title(f"{label} residuals")
        ax.legend()
        ax.grid(alpha=0.3)
    fig.tight_layout()
    if outpath:
        fig.savefig(outpath, dpi=110)
    plt.close(fig)
    return fig


def main(argv=None):
    import argparse

    from tqdne_tpu_torch.eval.report import read_eval_files

    parser = argparse.ArgumentParser("tqdne_tpu_torch.eval.residuals",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("files", nargs="+", help="cli.evaluate output HDF5 files")
    parser.add_argument("--out", default=None, help="JSON output path")
    parser.add_argument("--plot", default=None, help="figure output path (PNG)")
    parser.add_argument("--n-bins", type=int, default=20)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    arrays, provenance = read_eval_files(args.files, keys=(
        "target_waveform", "predicted_waveform", "hypocentral_distance", "magnitude", "vs30"))
    report = residual_report(arrays["target_waveform"], arrays["predicted_waveform"],
                             arrays["hypocentral_distance"], magnitude=arrays["magnitude"],
                             vs30=arrays["vs30"], n_bins=args.n_bins, device=args.device)
    # the residuals state the checkpoint and sampler that produced them; files that
    # differ are recorded as such (read_eval_files' "mixed")
    if provenance is not None:
        report["provenance"] = provenance
    if args.plot:
        plot_residuals(report, args.plot)
    text = json.dumps(report, indent=2)
    if args.out:
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
