"""Event archive -> ``raw_waveforms.h5``: the port of
``tqdne_tpu/cli/preprocess.py``.

The reference's four offline stages (its ``scripts/preprocessing/01..04``)
in one resumable orchestrator over the port's data primitives:

  01 select + ingest    catalog filters (rhyp <= 200 km, 4 <= mag <= 10,
                        depth <= 100 km), demean/detrend + causal 0.1 Hz
                        highpass, resampling to the common 100 Hz grid,
                        incremental per-event writes with a diary for resume
  02 gap repair         linear interpolation + frequency-constrained POCS
                        reconstruction of NaN gaps
  03 pick + align       P-onset picking and fixed-length cuts around the
                        pick (STA/LTA; ``--phasenet`` takes seisbench's
                        PhaseNet where seisbench is installed), and the
                        onshore/offshore class of the hypocentre
  04 filter             drop vs30 <= 0 and dead traces, re-pick and reject
                        records whose onset leaves the 2-7 s window, then
                        the validity index of each record

Stages 01-03 are numpy and scipy on the host; stage 04's dead-trace check and
validity scan run on ``--device`` (``cuda`` unless asked), the rest on the
host.  The HDF5 files need ``h5py``.

Input archive: an HDF5 of per-record groups, each with a ``waveform`` (C, T)
dataset and attributes {fs, rhyp, mag, depth, vs30} (optionally
azimuthal_gap and hypo_lat/hypo_lon):

    python -m tqdne_tpu_torch.cli.preprocess --archive archive.h5 --workdir W
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tqdne_tpu_torch.data import preprocessing as pp
from tqdne_tpu_torch.data.geo import classify_onshore
from tqdne_tpu_torch.data.quality import check_small_range, compute_validity_indices
from tqdne_tpu_torch.utils import resolve_device

TARGET_FS = 100.0
PRE_SAMPLES = 500  # 5 s before P
TRACE_LEN = 12501  # the reference's raw trace length (its stage 03 output)
FEATURE_NAMES = ("hypocentral_distance", "magnitude", "vs30", "hypocentre_depth",
                 "azimuthal_gap")


def process_archive(archive_path, workdir, *, trace_len: int = TRACE_LEN, resume: bool = True,
                    use_phasenet: bool = False) -> Path:
    """Stages 01-03 into ``<workdir>/data/processed_events.h5``, one group per
    kept record (a restart skips the records already there); returns its path."""
    import h5py

    workdir = Path(workdir)
    stage_path = workdir / "data" / "processed_events.h5"
    stage_path.parent.mkdir(parents=True, exist_ok=True)
    if not resume and stage_path.exists():
        stage_path.unlink()

    picker = _phasenet_picker() if use_phasenet else None

    n_done = n_skip = 0
    with h5py.File(archive_path, "r") as src, pp.IncrementalH5Writer(stage_path) as writer:
        for key in src:
            grp = src[key]
            rhyp, mag = grp.attrs["rhyp"], grp.attrs["mag"]
            depth, vs30 = grp.attrs["depth"], grp.attrs["vs30"]
            fs = float(grp.attrs.get("fs", TARGET_FS))
            if not pp.select_records(rhyp, mag, depth):
                n_skip += 1
                continue
            if writer.is_processed(key):
                continue
            wf = np.asarray(grp["waveform"], np.float64)  # (C, T)

            # 02: repair NaN gaps before filtering
            if np.isnan(wf).any():
                wf = np.stack([pp.spectral_gap_fill(tr, fs) if np.isnan(tr).any()
                               else np.nan_to_num(tr) for tr in wf])

            # 01: demean/detrend/highpass/resample to the 100 Hz grid
            wf = pp.preprocess_trace(wf, fs, TARGET_FS)

            # 03: pick P (vertical channel) and cut a fixed window
            if picker is not None:
                onset = picker(wf)
            else:
                onset = int(pp.pick_onset(wf[-1][None], TARGET_FS)[0])
            cut = pp.cut_around_onset(wf, onset, PRE_SAMPLES, trace_len)

            # 03: onshore/offshore hypocentre; -1 where the archive has no coordinates
            lat = grp.attrs.get("hypo_lat", grp.attrs.get("latitude"))
            lon = grp.attrs.get("hypo_lon", grp.attrs.get("longitude"))
            is_onshore = (int(classify_onshore(float(lat), float(lon))[0])
                          if lat is not None and lon is not None else -1)

            writer.write(key, {
                "waveform": cut.astype(np.float32),
                "features": np.array([rhyp, mag, vs30, depth,
                                      grp.attrs.get("azimuthal_gap", 0.0)], np.float32),
                "is_onshore": np.array(is_onshore, np.int64),
            })
            n_done += 1
    print(f"stage 01-03: processed {n_done}, filtered {n_skip} (resumable at {stage_path})")
    return stage_path


def finalize(stage_path, workdir, trace_len: int = TRACE_LEN, device="cuda") -> Path:
    """Stage 04 and assembly: the quality filters, then
    ``<workdir>/data/raw_waveforms.h5`` (waveforms stored (N, T, C), as
    ``cli.build_dataset`` reads them); returns its path."""
    import h5py

    device = resolve_device(device)
    wfs, feats, onshore = [], [], []
    with h5py.File(stage_path, "r") as f:
        for key in f:
            wfs.append(f[key]["waveform"][()])
            feats.append(f[key]["features"][()])
            # stage files from before the is_onshore column: unknown (-1)
            onshore.append(int(f[key]["is_onshore"][()]) if "is_onshore" in f[key] else -1)
    wf = np.stack(wfs)  # (N, C, T)
    feats = np.stack(feats)
    onshore = np.array(onshore, np.int64)

    on_device = torch.as_tensor(wf, device=device)
    keep = feats[:, 2] > 0  # vs30 > 0
    keep &= ~check_small_range(on_device).any(dim=-1).cpu().numpy()  # dead channels
    keep &= pp.p_window_filter(wf, TARGET_FS)  # onset inside 2-7 s
    wf, feats, onshore = wf[keep], feats[keep], onshore[keep]
    validity = compute_validity_indices(on_device[torch.as_tensor(keep, device=device)])

    out = Path(workdir) / "data" / "raw_waveforms.h5"
    with h5py.File(out, "w") as f:
        f.create_dataset("waveforms", data=np.swapaxes(wf, 1, 2))  # (N, T, C)
        f.create_dataset("indices_valid_waveforms", data=validity.cpu().numpy())
        f.create_dataset("is_onshore", data=onshore)
        for i, name in enumerate(FEATURE_NAMES):
            f.create_dataset(name, data=feats[:, i])
    print(f"stage 04: kept {keep.sum()}/{len(keep)} -> {out}")
    return out


def _phasenet_picker():
    try:
        import seisbench.models as sbm
    except ImportError:
        raise SystemExit("PhaseNet picking requires seisbench (not installed); omit --phasenet "
                         "to use the built-in STA/LTA picker") from None
    model = sbm.PhaseNet.from_pretrained("jma")

    def pick(wf):
        return int(np.argmax(model.annotate_stream_array(wf)))

    return pick


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.preprocess",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--archive", required=True, help="consolidated event archive HDF5")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--trace-len", type=int, default=TRACE_LEN)
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--phasenet", action="store_true",
                        help="pick with seisbench's PhaseNet (needs seisbench)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where stage 04's scans run")
    args = parser.parse_args(argv)
    stage = process_archive(args.archive, args.workdir, trace_len=args.trace_len,
                            resume=not args.no_resume, use_phasenet=args.phasenet)
    finalize(stage, args.workdir, args.trace_len, device=args.device)


if __name__ == "__main__":
    main()
