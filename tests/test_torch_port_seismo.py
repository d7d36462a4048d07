"""The port's seismological evaluation against the JAX package on the CPU:
every function of ``eval/seismo.py`` (the intensity measures on float64
tensors, the host statistics and the ground-motion models), the residual
report and the residuals CLI over HDF5 files the test writes.

Inputs: N = 6 three-component waveforms of 512 samples at 100 Hz, float64,
from a numpy seed, with a louder burst in the middle.  Tolerances: the FFT
paths to 1e-10 of the peak (elementwise outputs) or relative (peaks); the
response spectrum, in its device formulation (one FFT convolution) and its
plain loop, to rtol 1e-9; D5-95 exactly; the GMMs and host statistics to
1e-12; the residual report to 1e-9 with NaN positions equal.
"""

import ast
import json
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from tqdne_tpu.eval import residuals as jres
from tqdne_tpu.eval import seismo as J
from tqdne_tpu_torch.eval import residuals as pres
from tqdne_tpu_torch.eval import seismo as P

ROOT = Path(__file__).resolve().parents[1]
DT = 0.01
PERIODS = (0.02, 0.1, 0.3, 1, 2, 5)


@pytest.fixture
def waves(rng):
    wf = rng.standard_normal((6, 3, 512))
    wf[:, :, 150:260] *= 6.0
    return wf


@pytest.fixture
def table(rng):
    """Target and predicted waveforms with distances, magnitudes and vs30 of 40 rows."""
    n = 40
    target = rng.standard_normal((n, 3, 512)) * rng.uniform(0.5, 2.0, (n, 1, 1))
    predicted = target * rng.uniform(0.3, 3.0, (n, 1, 1)) + 0.1 * rng.standard_normal((n, 3, 512))
    return dict(target=target, predicted=predicted, dist=rng.uniform(5, 190, n),
                mag=rng.uniform(4.0, 7.5, n), vs30=rng.uniform(200, 800, n))


def _close(got, want, rtol, peak_relative=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    atol = rtol * np.nanmax(np.abs(want)) if peak_relative else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.parametrize("name", ["integrate_frequency_domain", "filter_frequency_domain"])
@pytest.mark.parametrize("highpass", [0.1, 2.0])
def test_frequency_domain_paths_match_jax(waves, name, highpass):
    got = getattr(P, name)(torch.from_numpy(waves), DT, highpass)
    assert got.dtype == torch.float64
    _close(got.numpy(), getattr(J, name)(waves, DT, highpass), 1e-10, peak_relative=True)


@pytest.mark.parametrize("pgv", [True, False])
@pytest.mark.parametrize("evaluate_obs", [True, False])
def test_evaluate_pgx_matches_jax(waves, rng, pgv, evaluate_obs):
    target = waves + 0.3 * rng.standard_normal(waves.shape)
    got = P.evaluate_pgx(torch.from_numpy(target), waves, DT, pgv=pgv, evaluate_obs=evaluate_obs)
    want = J.evaluate_pgx(target, waves, DT, pgv=pgv, evaluate_obs=evaluate_obs)
    if not evaluate_obs:
        got, want = {"gen": got}, {"gen": want}
    assert set(got) == set(want)
    for key in want:
        _close(got[key].numpy(), want[key], 1e-10)


def test_peaks_match_jax(waves, monkeypatch):
    c1, c2 = waves[:, 0], waves[:, 1]
    _close(P.rotation_invariant_peak(c1, c2).numpy(), J.rotation_invariant_peak(c1, c2), 1e-12)
    _close(P.gmrotd50(c1, c2).numpy(), J.gmrotd50(c1, c2), 1e-10)
    # batched over leading axes, in chunks of one row
    monkeypatch.setattr(P, "BUDGET_BYTES", 1)
    _close(P.gmrotd50(waves[:, :2], waves[:, 1:], num_angles=30).numpy(),
           J.gmrotd50(waves[:, :2], waves[:, 1:], num_angles=30), 1e-10)


@pytest.mark.parametrize("formulation", ["device", "plain loop"])
def test_response_spectrum_matches_jax(waves, formulation, monkeypatch):
    """SA(T) at (0.02, 0.1, 0.3, 1, 2, 5) s over a (6, 3) batch; the device
    formulation also in chunks of one row, and with a NaN sample (its row
    NaN at every period, as the loop's)."""
    fn = P.response_spectrum if formulation == "device" else P.response_spectrum_loop
    want = J.response_spectrum(waves, DT, PERIODS)
    got = fn(torch.from_numpy(waves), DT, PERIODS)
    assert got.shape == (6, 3, len(PERIODS)) and got.dtype == torch.float64
    _close(got.numpy(), want, 1e-9)
    nan = waves[:2].copy()
    nan[1, 2, 300] = np.nan
    _close(fn(nan, DT, PERIODS[:2]).numpy(), J.response_spectrum(nan, DT, PERIODS[:2]), 1e-9)
    if formulation == "device":
        monkeypatch.setattr(P, "BUDGET_BYTES", 1)
        _close(fn(waves, DT, PERIODS).numpy(), want, 1e-9)


@pytest.mark.parametrize("percentile", [50.0, 84.0])
def test_sa_rotd_matches_jax(waves, percentile, monkeypatch):
    c1, c2 = waves[:, 0].copy(), waves[:, 1]
    c1[3, 10] = np.nan
    want = J.sa_rotd(c1, c2, DT, PERIODS, percentile=percentile)
    _close(P.sa_rotd(torch.from_numpy(c1), c2, DT, PERIODS, percentile=percentile).numpy(),
           want, 1e-9)
    _close(P.sa_rotd(c1, c2, DT, PERIODS[1:3], percentile=percentile,
                     spectrum=P.response_spectrum_loop).numpy(),
           J.sa_rotd(c1, c2, DT, PERIODS[1:3], percentile=percentile), 1e-9)
    # batched over leading axes, in chunks of one row
    monkeypatch.setattr(P, "BUDGET_BYTES", 1)
    _close(P.sa_rotd(waves[:, :2], waves[:, 1:], DT, PERIODS[:3], percentile=percentile).numpy(),
           J.sa_rotd(waves[:, :2], waves[:, 1:], DT, PERIODS[:3], percentile=percentile), 1e-9)


def test_sa_distance_matches_jax(table):
    """Every key of the SA-distance evaluation, with an observed set and the
    GMM curves (both built-in models have no SA period: recorded as skipped)."""
    t, p = table["target"], table["predicted"]
    kw = dict(periods=(0.1, 0.3, 1.0, 2.0), obs_ns=t[:, 0], obs_ew=t[:, 1],
              obs_rhyp=table["dist"] * 0.9, mag=5.5, vs30=450.0, n_bins=12)
    want = J.sa_distance(p[:, 0], p[:, 1], table["dist"], DT, **kw)
    got = P.sa_distance(p[:, 0], p[:, 1], table["dist"], DT, device="cpu", **kw)
    assert set(got) == set(want)
    assert got["periods"] == want["periods"] and got["gmm_skipped"] == want["gmm_skipped"]
    assert set(got["gmm_sa"]) == set(want["gmm_sa"])
    for key, value in want.items():
        if key not in ("periods", "gmm_skipped", "gmm_sa"):
            _close(got[key], value, 1e-9)
    for model, value in want["gmm_sa"].items():
        _close(got["gmm_sa"][model], value, 1e-12)


def test_duration_and_arias_match_jax(waves):
    quiet = waves.copy()
    quiet[0, 0] = 0.0  # no energy: the floor on the total holds both at 0
    np.testing.assert_array_equal(P.significant_duration(quiet, DT).numpy(),
                                  J.significant_duration(quiet, DT))
    np.testing.assert_array_equal(P.significant_duration(quiet, DT, 0.2, 0.8).numpy(),
                                  J.significant_duration(quiet, DT, 0.2, 0.8))
    _close(P.arias_intensity(quiet, DT).numpy(), J.arias_intensity(quiet, DT), 1e-12)


@pytest.mark.parametrize("imt", ["PGA", "PGV"])
@pytest.mark.parametrize("vs30", [250.0, 760.0, 1600.0])
def test_ground_motion_models_match_jax(imt, vs30):
    rrup = np.linspace(1.0, 200.0, 37)
    for mag in (4.2, 5.5, 7.1):
        _close(P.kanno2006_shallow(imt, mag, rrup, vs30), J.kanno2006_shallow(imt, mag, rrup, vs30),
               1e-12)
        for rake in (None, 0.0, -90.0, 90.0, 170.0):
            _close(P.boore_etal_2014(imt, mag, rrup, vs30, rake),
                   J.boore_etal_2014(imt, mag, rrup, vs30, rake), 1e-12)
        _close(P.epri_epicentral_to_rjb(rrup, mag), J.epri_epicentral_to_rjb(rrup, mag), 1e-12)
        for model in ("Kanno2006Shallow", "BooreEtAl2014"):
            for corr in (False, True):
                _close(P.gmm_curve(imt, mag, rrup, vs30, model=model, rake=0.0,
                                   mean_convention_correction=corr),
                       J.gmm_curve(imt, mag, rrup, vs30, model=model, rake=0.0,
                                   mean_convention_correction=corr), 1e-12)
    for fn in (P.kanno2006_shallow, P.boore_etal_2014):
        with pytest.raises(NotImplementedError, match="requires openquake"):
            fn("SA(1.0)", 5.0, rrup)
    with pytest.raises(NotImplementedError, match="unknown GMM"):
        P.gmm_curve(imt, 5.0, rrup, model="Nope")


def test_host_statistics_match_jax(table, rng):
    obs, gen = np.exp(rng.standard_normal(40)), np.exp(rng.standard_normal(40))
    want = J.calculate_distance_binned_ratios(obs, gen, table["dist"], n_bins=9)
    got = P.calculate_distance_binned_ratios(obs, gen, table["dist"], n_bins=9)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], 1e-12)
    with pytest.raises(ValueError, match="same length"):
        P.calculate_distance_binned_ratios(obs, gen[:3], table["dist"])
    pga = np.abs(rng.standard_normal(10)) * 3
    for unit in ("g", "m/s^2", "cm/s2"):
        _close(P.pga_to_mmi(pga, unit), J.pga_to_mmi(pga, unit), 1e-12)
    data = table["target"][:4]
    _close(P.highpass_filter(data, 0.3, 100.0), J.highpass_filter(data, 0.3, 100.0), 1e-12)
    edges = np.linspace(0.1, 190, 8)
    for got_v, want_v in zip(P._distance_binned_percentiles(data[:, :2, 0], table["dist"][:4],
                                                            edges),
                             J._distance_binned_percentiles(data[:, :2, 0], table["dist"][:4],
                                                            edges)):
        _close(got_v, want_v, 1e-12)
    mmi = np.linspace(1, 10, 64)
    got_map, want_map = P.shakemap_colormap(mmi), J.shakemap_colormap(mmi)
    np.testing.assert_allclose(got_map(np.linspace(0, 1, 64)), want_map(np.linspace(0, 1, 64)),
                               rtol=1e-12)


def _report_close(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key in ("provenance", "bin_counts"):
            assert got[key] == value, key
        elif isinstance(value, dict):
            _report_close(got[key], value)
        else:
            _close(np.array(got[key], np.float64), np.array(value, np.float64), 1e-9)


@pytest.mark.parametrize("with_gmm", [True, False])
def test_residual_report_matches_jax(table, with_gmm):
    """Every key, the port's from a float32 tensor and a float64 array; 30 bins
    over 40 rows leave some empty (NaN in both).  numpy 2 takes a float32
    array's FFT in float32 (8e-7 off on the log ratios), so the JAX side gets
    the same values as float64, which the port computes in."""
    kw = dict(magnitude=table["mag"], vs30=table["vs30"]) if with_gmm else {}
    target = table["target"].astype(np.float32)
    want = jres.residual_report(target.astype(np.float64), table["predicted"], table["dist"],
                                n_bins=30, **kw)
    got = pres.residual_report(torch.from_numpy(target), table["predicted"], table["dist"],
                               n_bins=30, device="cpu", **kw)
    _report_close(got, want)
    assert 0 in got["PGA"]["bin_counts"]
    assert ("gmm_kanno2006_median" in got["PGV"]) == with_gmm


def _write_eval_file(path, table, rows, provenance):
    with h5py.File(path, "w") as f:
        f["target_waveform"] = table["target"][rows]
        f["predicted_waveform"] = table["predicted"][rows]
        f["hypocentral_distance"] = table["dist"][rows]
        f["magnitude"] = table["mag"][rows]
        f["vs30"] = table["vs30"][rows]
        if provenance is not None:
            f.attrs["provenance"] = json.dumps(provenance)


@pytest.mark.parametrize("provenance", ["common", "mixed"])
def test_residuals_cli_matches_jax(tmp_path, table, capsys, provenance):
    """Both CLIs over two rank files: equal JSON, the provenance of both files
    when they agree, each under ``mixed`` when they differ; the port's figure.
    The files hold float64 waveforms (numpy 2 would take the JAX side's FFT
    of float32 ones in float32)."""
    provs = [{"checkpoint": "a", "num_steps": 25}] * 2
    if provenance == "mixed":
        provs[1] = {"checkpoint": "b", "num_steps": 25}
    files = [tmp_path / f"r{i}.h5" for i in range(2)]
    for i, f in enumerate(files):
        _write_eval_file(f, table, slice(20 * i, 20 * (i + 1)), provs[i])
    args = [*map(str, files), "--n-bins", "10"]
    jres.main([*args, "--out", str(tmp_path / "jax.json")])
    pres.main([*args, "--out", str(tmp_path / "port.json"), "--plot", str(tmp_path / "r.png"),
               "--device", "cpu"])
    capsys.readouterr()
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    _report_close(got, want)
    assert ("mixed" in got["provenance"]) == (provenance == "mixed")
    assert (tmp_path / "r.png").stat().st_size > 0


def test_residual_report_refuses_a_missing_card(table):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pres.residual_report(table["target"], table["predicted"], table["dist"])


def _module_level_imports(module: str) -> set[str]:
    """Every module that importing ``module`` (a port module) imports at module
    level, following the port's own modules (imports inside functions, which
    run only when called, are left out)."""
    seen, todo, found = set(), [module], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        path = ROOT / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / name.replace(".", "/") / "__init__.py"
        for node in ast.parse(path.read_text()).body:
            names = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            for imported in names:
                found.add(imported)
                if imported.startswith("tqdne_tpu_torch") and (
                        (ROOT / (imported.replace(".", "/") + ".py")).exists()):
                    todo.append(imported)
    return found


@pytest.mark.parametrize("module", ["tqdne_tpu_torch.eval.seismo",
                                    "tqdne_tpu_torch.eval.residuals",
                                    "tqdne_tpu_torch.train.callbacks",
                                    "tqdne_tpu_torch.cli.train"])
def test_imports_no_matplotlib(module):
    """The card has no matplotlib: the seismology, the callback and the train
    CLI import it (through ``eval.plots``) only inside the functions that draw."""
    found = _module_level_imports(module)
    assert "torch" in found
    assert not {n for n in found if n.split(".")[0] == "matplotlib" or "eval.plots" in n}
