"""Export generated waveforms to SeisBench-style datasets: the port of
``tqdne_tpu/data/export.py`` (numpy and scipy, as there).

The reference's ``scripts/write_to_seisbench.py``: recursive STA/LTA onset
picking with hysteresis triggering, travel-time shifted start times
(Vp = 5.5 km/s), per-trace metadata rows, and seisbench's
``WaveformDataWriter``.  Without seisbench the same metadata and (N, C, T)
waveforms are written as a portable HDF5 + CSV pair with the same column
names, which seisbench can load later.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

VP_KM_S = 5.5  # crustal P velocity used for travel-time alignment


def recursive_sta_lta(trace: np.ndarray, nsta: int, nlta: int) -> np.ndarray:
    """Recursive STA/LTA characteristic function (obspy-compatible):
    exponentially-averaged short/long-term energies."""
    trace = np.asarray(trace, np.float64)
    csta, clta = 1.0 / nsta, 1.0 / nlta
    sq = trace**2
    sta = np.zeros_like(sq)
    lta = np.zeros_like(sq)
    # scipy lfilter computes the exponential moving averages in C
    from scipy.signal import lfilter

    sta = lfilter([csta], [1, -(1 - csta)], sq)
    lta = lfilter([clta], [1, -(1 - clta)], sq)
    out = np.where(lta > 1e-30, sta / np.maximum(lta, 1e-30), 0.0)
    out[..., :nlta] = 0.0
    return out


def trigger_onset(cft: np.ndarray, on: float, off: float) -> list[tuple[int, int]]:
    """Hysteresis trigger windows (obspy trigger_onset role): rising
    crossings of ``on`` paired with the next fall below ``off``."""
    above_on = cft >= on
    pairs = []
    i = 0
    n = len(cft)
    while i < n:
        if above_on[i]:
            start = i
            while i < n and cft[i] >= off:
                i += 1
            pairs.append((start, min(i, n - 1)))
        else:
            i += 1
    return pairs


def pick_trace_start_time(data: np.ndarray, sampling_rate: float) -> float:
    """Onset (seconds) from recursive STA/LTA with (1.5, 0.5) thresholds
    (write_to_seisbench.py:166-175)."""
    cft = recursive_sta_lta(data, int(2 * sampling_rate), int(5 * sampling_rate))
    on_off = trigger_onset(cft, 1.5, 0.5)
    if on_off:
        return on_off[0][0] / sampling_rate
    return 0.0


def export_seisbench(
    waveforms: np.ndarray,
    features: dict,
    outdir: str | Path,
    *,
    sampling_rate: float = 100.0,
    component_order: str = "ZNE",
    source_origin_time: str = "2020-01-01T00:00:00",
) -> tuple[Path, Path]:
    """Write (N, C, T) waveforms + per-trace features to a SeisBench
    dataset (metadata.csv + waveforms.hdf5).

    ``features`` maps feature name -> (N,) array; expected keys follow
    the storage contract (hypocentral_distance, magnitude, vs30,
    hypocentre_depth, azimuthal_gap).
    """
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    metadata_path = outdir / "metadata.csv"
    waveforms_path = outdir / "waveforms.hdf5"

    n = len(waveforms)
    rows = []
    for i in range(n):
        onset_s = pick_trace_start_time(waveforms[i, 0], sampling_rate)
        travel_time = float(features["hypocentral_distance"][i]) / VP_KM_S
        rows.append(
            {
                "trace_name": f"generated_{i:06d}",
                "trace_sampling_rate_hz": sampling_rate,
                "trace_component_order": component_order,
                "trace_start_time": source_origin_time,
                "trace_P1_arrival_sample": int(onset_s * sampling_rate),
                "trace_P1_status": "automatic",
                "path_travel_time_s": travel_time,
                "source_magnitude": float(features["magnitude"][i]),
                "path_hyp_distance_km": float(features["hypocentral_distance"][i]),
                "source_depth_km": float(features["hypocentre_depth"][i]),
                "station_vs30_mps": float(features["vs30"][i]),
                "path_azimuthal_gap_deg": float(features["azimuthal_gap"][i]),
                "trace_category": "generated",
            }
        )

    try:  # native seisbench writer when available
        import seisbench.data as sbd

        with sbd.WaveformDataWriter(str(metadata_path), str(waveforms_path)) as writer:
            writer.data_format = {
                "dimension_order": "CW",
                "component_order": component_order,
                "measurement": "acceleration",
                "unit": "m/s2",
                "instrument_response": "not restituted",
            }
            for row, wf in zip(rows, waveforms):
                writer.add_trace(row, np.asarray(wf))
        return metadata_path, waveforms_path
    except ImportError:
        pass

    # portable fallback: identical columns, plain HDF5
    import h5py

    with open(metadata_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    with h5py.File(waveforms_path, "w") as f:
        f.attrs["dimension_order"] = "CW"
        f.attrs["component_order"] = component_order
        grp = f.create_group("data")
        for row, wf in zip(rows, waveforms):
            grp.create_dataset(row["trace_name"], data=np.asarray(wf, np.float32))
    return metadata_path, waveforms_path
