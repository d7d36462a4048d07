"""A STEAD chunk -> ``raw_waveforms.h5``: the port of
``tqdne_tpu/cli/build_stead.py`` (numpy, pandas and ``h5py`` on the host).

The reference's ``experiments/create_dataset_from_STEAD.py``: keep
trace_category == earthquake_local, source_distance_km <= 200 and
source_magnitude > 4.5; cut each trace from 5 s before the P arrival to 60 s
in all; the azimuthal gap from the hypocentre and station coordinates; vs30
from a column, else the reference's random placeholder; written to the
``raw_waveforms.h5`` storage contract that ``cli.build_dataset`` reads.

Instrument-response removal to acceleration needs obspy and an IRIS
connection, and is gated: ``--counts-ok`` passes raw counts through (for
offline or synthetic data); without it, obspy must be installed.

STEAD chunk format: a CSV metadata table and an HDF5 with /data/<trace_name>
datasets shaped (T, 3) in ENZ order at 100 Hz:

    python -m tqdne_tpu_torch.cli.build_stead --csv chunk.csv --hdf5 chunk.hdf5 \\
        --workdir W --counts-ok
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tqdne_tpu_torch.data.preprocessing import azimuthal_gap, cut_around_onset

FS = 100.0
PRE_S = 5.0
TOTAL_S = 60.0


def filter_metadata(df):
    """The reference's selection of local earthquakes."""
    return df[
        (df.trace_category == "earthquake_local")
        & (df.source_distance_km <= 200)
        & (df.source_magnitude > 4.5)
    ]


def build(csv_path, hdf5_path, workdir, *, counts_ok=False, seed=42, limit=None):
    import h5py
    import pandas as pd

    rng = np.random.default_rng(seed)  # the reference seeds numpy with 42
    df = filter_metadata(pd.read_csv(csv_path))
    if limit:
        df = df.iloc[:limit]

    remove_response = not counts_ok
    if remove_response:
        try:
            import obspy  # noqa: F401
        except ImportError:
            raise SystemExit(
                "obspy is not available for instrument-response removal; pass "
                "--counts-ok if the waveforms are already in physical units"
            )

    total = int(TOTAL_S * FS)
    pre = int(PRE_S * FS)
    waveforms, feats = [], {k: [] for k in (
        "hypocentral_distance", "magnitude", "vs30", "hypocentre_depth", "azimuthal_gap")}

    with h5py.File(hdf5_path, "r") as f:
        for _, row in df.iterrows():
            name = row["trace_name"]
            if f"data/{name}" not in f:
                continue
            data = f[f"data/{name}"][()]  # (T, 3) ENZ
            if data.ndim != 2 or data.shape[1] != 3:
                continue
            trace = np.nan_to_num(data.T.astype(np.float32))  # (3, T)
            onset = int(row.get("p_arrival_sample", pre))
            cut = cut_around_onset(trace, onset, pre, total)

            waveforms.append(cut)
            feats["hypocentral_distance"].append(float(row["source_distance_km"]))
            feats["magnitude"].append(float(row["source_magnitude"]))
            feats["hypocentre_depth"].append(float(row["source_depth_km"]))
            vs30 = row.get("station_vs30_mps", np.nan)
            feats["vs30"].append(
                float(vs30) if np.isfinite(vs30) else float(rng.integers(400, 1501))
            )
            hypo = (row["source_latitude"], row["source_longitude"])
            stations = [(row["receiver_latitude"], row["receiver_longitude"])]
            feats["azimuthal_gap"].append(azimuthal_gap(hypo, stations))

    if not waveforms:
        raise SystemExit("no traces passed the filters")

    out = Path(workdir) / "data" / "raw_waveforms.h5"
    out.parent.mkdir(parents=True, exist_ok=True)
    wf = np.stack(waveforms)  # (N, 3, T)
    with h5py.File(out, "w") as f:
        # storage contract: waveforms stored (N, T, C) pre-build_dataset
        f.create_dataset("waveforms", data=np.swapaxes(wf, 1, 2))
        f.create_dataset("indices_valid_waveforms", data=np.full(len(wf), wf.shape[-1]))
        for k, v in feats.items():
            f.create_dataset(k, data=np.asarray(v, np.float32))
    print(f"wrote {out} ({len(wf)} traces)")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.build_stead",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--csv", required=True, help="STEAD chunk metadata CSV")
    parser.add_argument("--hdf5", required=True, help="STEAD chunk waveform HDF5")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--counts-ok", action="store_true",
                        help="skip instrument-response removal")
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    build(args.csv, args.hdf5, args.workdir, counts_ok=args.counts_ok, limit=args.limit)


if __name__ == "__main__":
    main()
