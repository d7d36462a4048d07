"""The port's offline data pipeline against the JAX package on the CPU: every
function of ``utils/io.py``, ``data/geo.py``, ``data/quality.py``,
``data/preprocessing.py`` and ``data/export.py`` on the fixtures of the JAX
package's own tests (their fixture helpers copied here), and the CLIs
``preprocess`` -> ``build_dataset`` and ``build_stead`` on the same inputs,
file against file, dataset by dataset.

The host modules are the same numpy and scipy code, so they must agree
exactly; so must the torch scans (``data/quality.py``), against the numpy
functions and the native ``_fastops`` scan alike.
"""

import csv
import importlib.util

import h5py
import numpy as np
import pytest
import torch

from tqdne_tpu import _fastops
from tqdne_tpu.cli import build_dataset as jax_build_dataset
from tqdne_tpu.cli import build_stead as jax_build_stead
from tqdne_tpu.cli import preprocess as jax_preprocess
from tqdne_tpu.data import export as jexport
from tqdne_tpu.data import geo as jgeo
from tqdne_tpu.data import preprocessing as jpp
from tqdne_tpu.data import quality as jq
from tqdne_tpu.utils import io as jio
from tqdne_tpu_torch.cli import build_dataset, build_stead, preprocess
from tqdne_tpu_torch.data import export, geo, quality
from tqdne_tpu_torch.data import preprocessing as pp
from tqdne_tpu_torch.data.dataset import Dataset
from tqdne_tpu_torch.data.representation import LogSpectrogram
from tqdne_tpu_torch.utils import io


def _trace(rng, n=2048):
    """tests/test_quality.py's trace: a windowed 3 Hz burst over faint noise."""
    t = np.arange(n) / 100.0
    return (np.sin(2 * np.pi * 3 * t) * np.exp(-(((t - 8) / 4) ** 2))
            + 0.001 * rng.standard_normal(n)).astype(np.float64)


def _waveform_with_onset(rng, onset=1000, n=4064):
    """tests/test_export.py's waveform: noise, then a decaying 4 Hz arrival."""
    x = 0.01 * rng.standard_normal(n)
    t = np.arange(n - onset) / 100.0
    x[onset:] += np.sin(2 * np.pi * 4 * t) * np.exp(-t / 8)
    return x


def _faulty_batch(rng, dtype):
    """(6, 3, 2048) records with each fault of tests/test_quality.py: a record
    dead halfway, a channel dead late, a straight-line tail, a constant
    channel, and samples exactly at the adaptive threshold."""
    wf = np.stack([np.stack([_trace(rng) for _ in range(3)]) for _ in range(6)])
    wf[0, :, 1024:] = 0.0
    wf[1, 1, 1500:] = 0.0
    wf[2, 0, 1000:] = np.linspace(0.0, 0.8, 1048)
    wf[3, 2] = 0.5
    wf = wf.astype(dtype)
    peak = np.abs(wf[5, 1]).max()
    wf[5, 1, 1800::7] = (peak * dtype(0.001)).astype(dtype)  # exactly at the threshold
    return wf


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_quality_checks_match_jax(rng, dtype):
    wf = _faulty_batch(rng, dtype)
    t = torch.from_numpy(wf)
    has, idx = quality.check_trailing_zeros(t)
    want_has, want_idx = jq.check_trailing_zeros(wf)
    np.testing.assert_array_equal(has.numpy(), want_has)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(quality.check_small_range(t).numpy(), jq.check_small_range(wf))
    np.testing.assert_array_equal(quality.find_last_oscillating_sample(t).numpy(),
                                  jq.find_last_oscillating_sample(wf))
    np.testing.assert_array_equal(quality.check_linear_trend(t).numpy(),
                                  jq.check_linear_trend(wf))
    assert quality.check_linear_trend(t).any() and not quality.check_linear_trend(t).all()
    report, want = quality.quality_report(t), jq.quality_report(wf)
    assert set(report) == set(want)
    for key in want:
        assert report[key].device == t.device
        np.testing.assert_array_equal(report[key].numpy(), want[key], err_msg=key)


@pytest.mark.parametrize("case", ["faults", "nan", "short", "silent"])
def test_validity_indices_match_the_native_scan(rng, case):
    """``compute_validity_indices`` against the JAX function (its native scan,
    built by the test configuration) and ``_fastops`` itself, exactly: on the
    faults, with a NaN sample (ignored by the native scan's peak), on traces
    too short for a window pair (T // 2) and on all-zero records."""
    wf = _faulty_batch(rng, np.float32)
    if case == "nan":
        wf[4, 0, 300] = np.nan
    elif case == "short":
        wf = wf[..., :40]
    elif case == "silent":
        wf[1:3] = 0.0
    got = quality.compute_validity_indices(torch.from_numpy(wf))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jq.compute_validity_indices(wf))
    np.testing.assert_array_equal(got.numpy(), _fastops.validity_indices(wf, 20, 2))
    if case != "nan":  # finite: the numpy function's channel maximum too
        np.testing.assert_array_equal(
            got.numpy(), jq.find_last_oscillating_sample(wf).max(axis=-1))


def test_linear_trend_r2_is_the_host_formula_bit_for_bit(rng):
    """The tail windows' R^2 against ``tqdne_tpu/data/quality.py:check_linear_trend``'s
    own arithmetic (numpy cumsum window sums in float64), to the last bit,
    over a quiet tail where prefix differences cancel."""
    wf = _faulty_batch(rng, np.float64)
    wf[4, :, 1200:] *= 1e-7
    n, m = wf.shape[-1], 300
    t = np.arange(m)
    t_mean, t_var = t.mean(), ((t - t.mean()) ** 2).sum()
    sum_y = jq._window_sums(wf, m)
    sum_ty = jq._window_sums(wf * np.arange(n), m) - np.arange(n - m + 1) * sum_y
    sum_y2 = jq._window_sums(wf**2, m)
    beta = (sum_ty - t_mean * sum_y) / t_var
    y_mean = sum_y / m
    ss_tot = sum_y2 - m * y_mean**2
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.where(ss_tot > 1e-20, beta**2 * t_var / ss_tot, 0.0)
    got = quality.linear_trend_r2(torch.from_numpy(wf)).numpy()
    np.testing.assert_array_equal(got, r2[..., (n - m + 1) * 2 // 3:])


def test_preprocessing_functions_match_jax(rng, tmp_path):
    x = np.array([0.0, np.nan, 2.0, np.nan, np.nan, 5.0])
    np.testing.assert_array_equal(pp.linear_interpolate_nans(x), jpp.linear_interpolate_nans(x))
    fs = 100.0
    t = np.arange(2048) / fs
    gappy = np.sin(2 * np.pi * 3 * t) + 0.5 * np.sin(2 * np.pi * 7 * t)
    gappy[500:540] = np.nan
    gappy[1200:1220] = np.nan
    for kw in ({}, {"num_iters": 30, "adaptive_band": True}):
        np.testing.assert_array_equal(pp.spectral_gap_fill(gappy, fs, **kw),
                                      jpp.spectral_gap_fill(gappy, fs, **kw))
    mostly_missing = np.full(100, np.nan)
    mostly_missing[:40] = 1.0
    with pytest.raises(ValueError, match="Insufficient valid data points"):
        pp.spectral_gap_fill(mostly_missing)

    lat1, lon1, lat2, lon2 = rng.uniform(-60, 60, (4, 16))
    np.testing.assert_array_equal(pp.azimuth_deg(lat1, lon1, lat2, lon2),
                                  jpp.azimuth_deg(lat1, lon1, lat2, lon2))
    for stations in ([(1, 0), (0, 1), (-1, 0)], [(0, 1)], rng.uniform(-5, 5, (7, 2))):
        assert pp.azimuthal_gap((0.3, -0.2), stations) == \
            jpp.azimuthal_gap((0.3, -0.2), stations)

    onset_trace = _waveform_with_onset(rng, onset=2000, n=4096)[None]
    np.testing.assert_array_equal(pp.classic_sta_lta(onset_trace, 50, 1000),
                                  jpp.classic_sta_lta(onset_trace, 50, 1000))
    np.testing.assert_array_equal(pp.pick_onset(onset_trace, fs), jpp.pick_onset(onset_trace, fs))
    rhyp, mag, depth = rng.uniform(0, 300, 20), rng.uniform(2, 8, 20), rng.uniform(0, 150, 20)
    np.testing.assert_array_equal(pp.select_records(rhyp, mag, depth),
                                  jpp.select_records(rhyp, mag, depth))
    x = 3.0 + np.sin(2 * np.pi * 5 * np.arange(8192) / 200.0)
    np.testing.assert_array_equal(pp.preprocess_trace(x, 200.0, 100.0),
                                  jpp.preprocess_trace(x, 200.0, 100.0))
    batch = np.stack([np.stack([_waveform_with_onset(rng, onset=300 + 40 * i)
                                for _ in range(3)]) for i in range(6)])
    np.testing.assert_array_equal(pp.p_window_filter(batch), jpp.p_window_filter(batch))
    trace = np.arange(200.0).reshape(2, 100)
    for onset, pre, total in ((10, 20, 50), (90, 5, 50), (0, 0, 100), (150, 10, 30)):
        np.testing.assert_array_equal(pp.cut_around_onset(trace, onset, pre, total),
                                      jpp.cut_around_onset(trace, onset, pre, total))

    # IncrementalH5Writer: the same files and diaries, a repeated key skipped
    for lib, name in ((pp, "port"), (jpp, "jax")):
        with lib.IncrementalH5Writer(tmp_path / f"{name}.h5") as writer:
            assert writer.write("EQ0", {"waveform": np.ones((3, 4))})
            assert not writer.write("EQ0", {"waveform": np.zeros((3, 4))})
            assert writer.write("EQ1", {"features": np.arange(5.0)})
            assert writer.processed_keys == {"EQ0", "EQ1"} and writer.is_processed("EQ1")
    assert (tmp_path / "port.h5.diary").read_text() == (tmp_path / "jax.h5.diary").read_text()
    _assert_h5_equal(tmp_path / "port.h5", tmp_path / "jax.h5")


def test_export_functions_match_jax(rng, tmp_path):
    x = _waveform_with_onset(rng, onset=1200)
    np.testing.assert_array_equal(export.recursive_sta_lta(x, 200, 500),
                                  jexport.recursive_sta_lta(x, 200, 500))
    for cft in (np.array([0, 0, 2.0, 2.0, 1.0, 0.4, 0, 2.0, 0.3]),
                jexport.recursive_sta_lta(x, 200, 500)):
        assert export.trigger_onset(cft, 1.5, 0.5) == jexport.trigger_onset(cft, 1.5, 0.5)
    assert export.pick_trace_start_time(x, 100.0) == jexport.pick_trace_start_time(x, 100.0)
    assert export.pick_trace_start_time(np.zeros(2000), 100.0) == 0.0

    n = 5
    wf = np.stack([np.stack([_waveform_with_onset(rng) for _ in range(3)]) for _ in range(n)])
    feats = {k: rng.uniform(lo, hi, n) for k, lo, hi in (
        ("hypocentral_distance", 10, 200), ("magnitude", 4.5, 7), ("vs30", 200, 800),
        ("hypocentre_depth", 5, 50), ("azimuthal_gap", 30, 300))}
    meta, wave = export.export_seisbench(wf, feats, tmp_path / "port")
    want_meta, want_wave = jexport.export_seisbench(wf, feats, tmp_path / "jax")
    assert meta.read_text() == want_meta.read_text()
    assert len(list(csv.DictReader(open(meta)))) == n
    _assert_h5_equal(wave, want_wave)


def test_geo_matches_jax(rng):
    for ring, want in zip(geo.JAPAN_POLYGONS, jgeo.JAPAN_POLYGONS, strict=True):
        np.testing.assert_array_equal(ring, want)
    lat, lon = rng.uniform(24, 47, 400), rng.uniform(122, 148, 400)
    got = geo.classify_onshore(lat, lon, method="coarse")
    np.testing.assert_array_equal(got, jgeo.classify_onshore(lat, lon, method="coarse"))
    assert 0 < got.sum() < len(got) and got.dtype == np.int64
    lshape = np.array([(0, 0), (2, 0), (2, 1), (1, 1), (1, 2), (0, 2)], float)
    px, py = rng.uniform(-0.5, 2.5, (2, 50))
    np.testing.assert_array_equal(geo.points_in_polygon(px, py, lshape),
                                  jgeo.points_in_polygon(px, py, lshape))


def test_io_matches_jax(tmp_path, rng):
    from scipy.io import savemat

    data = {"wfMat": rng.standard_normal((4, 16)).astype(np.float32),
            "meta": {"mag": 6.1, "rhyp": 42.0}}
    savemat(tmp_path / "gan.mat", data)
    got, want = io.load_mat(tmp_path / "gan.mat"), jio.load_mat(tmp_path / "gan.mat")
    np.testing.assert_array_equal(got["wfMat"], want["wfMat"])
    assert got["meta"] == want["meta"]
    with h5py.File(tmp_path / "v73.h5", "w") as f:  # the v7.3 (HDF5) branch
        f.create_dataset("a", data=np.arange(3))
        f.create_group("g").create_dataset("b", data=2.5)
    with h5py.File(tmp_path / "v73.h5") as f:
        assert io._h5_to_dict(f["g"]) == jio._h5_to_dict(f["g"]) == {"b": 2.5}

    path = tmp_path / "p.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("magnitude", data=rng.uniform(4, 8, 10))
        f.create_dataset("vs30s", data=rng.uniform(200, 800, 10))
        f.create_dataset("waveforms", data=rng.standard_normal((10, 3, 64)).astype(np.float32))
    p, jp = io.SeismicParameters(path), jio.SeismicParameters(path)
    for name in ("magnitude", "vs30", "vs30s", "waveforms"):
        np.testing.assert_array_equal(getattr(p, name), getattr(jp, name))
    assert p.keys() == jp.keys() and p.get_data_info() == jp.get_data_info()
    assert repr(p) == repr(jp)
    with pytest.raises(AttributeError):
        p.nonexistent
    p.close()
    jp.close()


def _assert_h5_equal(got_path, want_path):
    """Every dataset and attribute of two HDF5 files equal, names, shapes and dtypes too."""
    with h5py.File(got_path) as got, h5py.File(want_path) as want:
        names, want_names = [], []
        got.visit(names.append)
        want.visit(want_names.append)
        assert sorted(names) == sorted(want_names)
        assert dict(got.attrs) == dict(want.attrs)
        for name in want_names:
            if isinstance(want[name], h5py.Dataset):
                assert got[name].dtype == want[name].dtype, name
                np.testing.assert_array_equal(got[name][()], want[name][()], err_msg=name)
            assert dict(got[name].attrs) == dict(want[name].attrs), name


@pytest.fixture
def archive(tmp_path, rng):
    """tests/test_preprocess_cli.py's synthetic archive: 8 records at 200 Hz,
    one with a NaN gap, one too far, one too small, one with vs30 < 0, half
    the hypocentres onshore."""
    fs = 200.0
    n_t = 2 * 12501 + 4000
    path = tmp_path / "archive.h5"
    with h5py.File(path, "w") as f:
        for i in range(8):
            g = f.create_group(f"EQ{i:03d}")
            onset = 6000 + 200 * i
            x = 0.005 * rng.standard_normal((3, n_t))
            t = np.arange(n_t - onset) / fs
            x[:, onset:] += np.sin(2 * np.pi * 4 * t) * np.exp(-t / 10)
            if i == 3:
                x[0, 8000:8040] = np.nan  # gap to repair
            g.create_dataset("waveform", data=x.astype(np.float32))
            g.attrs["fs"] = fs
            g.attrs["rhyp"] = 50.0 + 10 * i if i != 5 else 400.0
            g.attrs["mag"] = 5.5 if i != 6 else 2.0
            g.attrs["depth"] = 20.0
            g.attrs["vs30"] = 400.0 if i != 7 else -1.0
            g.attrs["azimuthal_gap"] = 120.0
            g.attrs["hypo_lat"] = 36.65 if i % 2 == 0 else 38.32
            g.attrs["hypo_lon"] = 138.18 if i % 2 == 0 else 142.37
    return path


def test_preprocess_and_build_dataset_match_jax(archive, tmp_path):
    """``preprocess`` -> ``build_dataset`` through the port's CLIs (the scans
    on the CPU) and the JAX package's, on the same archive: the stage file,
    ``raw_waveforms.h5`` and ``preprocessed_waveforms.h5`` equal dataset by
    dataset; then the port's ``Dataset`` reads the result.  A resumed run
    keeps its records."""
    port_wd, jax_wd = tmp_path / "port", tmp_path / "jax"
    preprocess.main(["--archive", str(archive), "--workdir", str(port_wd), "--trace-len",
                     "4064", "--device", "cpu"])
    jax_preprocess.main(["--archive", str(archive), "--workdir", str(jax_wd), "--trace-len",
                         "4064"])
    for name in ("processed_events.h5", "raw_waveforms.h5"):
        _assert_h5_equal(port_wd / "data" / name, jax_wd / "data" / name)
    assert (port_wd / "data" / "processed_events.h5.diary").read_text() == \
        (jax_wd / "data" / "processed_events.h5.diary").read_text()
    with h5py.File(port_wd / "data" / "raw_waveforms.h5") as f:
        n = len(f["waveforms"])
        assert 1 <= n <= 5 and set(np.unique(f["is_onshore"][:])) == {0, 1}

    stage = preprocess.process_archive(archive, port_wd, trace_len=4064, resume=True)
    _assert_h5_equal(stage, jax_wd / "data" / "processed_events.h5")

    build_dataset.main(["--workdir", str(port_wd)])
    jax_build_dataset.main(["--workdir", str(jax_wd)])
    path = port_wd / "data" / "preprocessed_waveforms.h5"
    _assert_h5_equal(path, jax_wd / "data" / "preprocessed_waveforms.h5")
    ds = Dataset(path, LogSpectrogram(hop_size=32, n_iter=2), cut=4064, cond=True, split="full")
    batch = ds.load_batch(np.arange(len(ds)))
    assert len(ds) == n and batch["signal"].shape == (n, 3, 128, 128)
    assert np.isfinite(batch["signal"]).all() and batch["cond"].shape == (n, 5)


def test_preprocess_cli_defaults_to_the_card(archive, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess.main(["--archive", str(archive), "--workdir", str(tmp_path / "w"),
                         "--trace-len", "4064"])


@pytest.fixture
def stead_chunk(tmp_path, rng):
    """tests/test_build_stead.py's synthetic STEAD chunk: 12 traces, a third
    of them noise, some too far or too small."""
    import pandas as pd

    rows = []
    with h5py.File(tmp_path / "chunk.hdf5", "w") as f:
        grp = f.create_group("data")
        for i in range(12):
            name = f"TRACE{i:04d}_EV"
            grp.create_dataset(name, data=rng.standard_normal((8000, 3)).astype(np.float32))
            rows.append({
                "trace_name": name,
                "trace_category": "earthquake_local" if i % 4 else "noise",
                "source_distance_km": 100.0 if i % 3 else 350.0,
                "source_magnitude": 5.5 if i % 2 else 3.0,
                "source_depth_km": 20.0,
                "source_latitude": 36.0,
                "source_longitude": 138.0,
                "receiver_latitude": 36.5,
                "receiver_longitude": 138.5,
                "p_arrival_sample": 1000,
            })
    pd.DataFrame(rows).to_csv(tmp_path / "chunk.csv", index=False)
    return tmp_path


def test_build_stead_matches_jax(stead_chunk):
    import pandas as pd

    df = pd.read_csv(stead_chunk / "chunk.csv")
    pd.testing.assert_frame_equal(build_stead.filter_metadata(df),
                                  jax_build_stead.filter_metadata(df))
    args = ["--csv", str(stead_chunk / "chunk.csv"), "--hdf5", str(stead_chunk / "chunk.hdf5"),
            "--counts-ok"]
    build_stead.main(args + ["--workdir", str(stead_chunk / "port")])
    jax_build_stead.main(args + ["--workdir", str(stead_chunk / "jax")])
    got = stead_chunk / "port" / "data" / "raw_waveforms.h5"
    _assert_h5_equal(got, stead_chunk / "jax" / "data" / "raw_waveforms.h5")
    with h5py.File(got) as f:
        assert f["waveforms"].shape[1:] == (6000, 3)
    build_dataset.run(stead_chunk / "port")
    ds = Dataset(stead_chunk / "port" / "data" / "preprocessed_waveforms.h5",
                 LogSpectrogram(hop_size=32, n_iter=2), cut=4064, cond=True, split="full")
    assert ds.load_batch(np.arange(len(ds)))["waveform"].shape[1:] == (3, 4064)
    if importlib.util.find_spec("obspy") is None:  # without --counts-ok: refused
        with pytest.raises(SystemExit, match="obspy is not available"):
            build_stead.build(stead_chunk / "chunk.csv", stead_chunk / "chunk.hdf5",
                              stead_chunk / "port")
