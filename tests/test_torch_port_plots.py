"""The port's figures, report figures, sampling-eval callback and its wiring
against the JAX package on the CPU.

- Every class of ``eval/plots.py`` on the same inputs (the port's given
  torch tensors, the JAX package's arrays): each figure's axes, titles and
  labels, every line's data (``Line2D.get_xydata()``), every image array (the
  Bin and likelihood matrices) and every text, to 1e-9; and
  ``lognormal_likelihood_matrix``.
- ``report_figures`` and the report's ``--figures``: the same seven files.
- ``SamplingEvalCallback`` beside the JAX one, on stub sample functions that
  return the same arrays: the ``eval/`` scalars to 1e-6, the figure names, the
  NaN guard, the failure counter, the batch-size error and the period.
- ``Trainer(callbacks=)``: each epoch's callback after its validation and
  before its checkpoint.
- The train CLI with ``--eval-every 1 --tiny --device cpu`` for
  ``latent_edm``, ``consistency`` and ``ddpm`` (2 timesteps set on the port's
  own ``DDPMConfig``): the ``eval/`` scalars and the JAX CLI's figure names;
  and for all eight diffusion recipes, the sampler at the JAX step
  factories' defaults.

Inputs come from numpy with a seed: waveforms of 3 x 256 samples at 100 Hz.
"""

import functools
import inspect
import json
import logging

import h5py
import numpy as np
import pytest
import torch

from tqdne_tpu import configs as jconfigs
from tqdne_tpu.data import representation as jrep
from tqdne_tpu.diffusion import consistency as jcons
from tqdne_tpu.eval import metrics as JM
from tqdne_tpu.eval import plots as JP
from tqdne_tpu.eval import report as jreport
from tqdne_tpu.train import steps as jsteps
from tqdne_tpu.train.callbacks import SamplingEvalCallback as JaxCallback
from tqdne_tpu.train.loop import MetricWriter as JaxWriter
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.data import representation as prep
from tqdne_tpu_torch.diffusion import consistency as cons
from tqdne_tpu_torch.diffusion import ddpm
from tqdne_tpu_torch.eval import metrics as PM
from tqdne_tpu_torch.eval import plots as PP
from tqdne_tpu_torch.eval import report as preport
from tqdne_tpu_torch.train import steps as psteps
from tqdne_tpu_torch.train.callbacks import SamplingEvalCallback
from tqdne_tpu_torch.train.loop import MetricWriter, Trainer
from tqdne_tpu_torch.train.state import TrainState
from tqdne_tpu_torch.utils import fold_seed

MAG_BINS, DIST_BINS = [4, 5.5, 7, 9.1], [0, 60, 120, 200]
KEYS = ("hypocentral_distance", "magnitude", "vs30", "hypocentre_depth", "azimuthal_gap")
STATS = np.array([[100.0, 50.0], [5.5, 1.0], [400.0, 100.0], [20.0, 10.0], [90.0, 30.0]])


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def data(rng):
    n = 24
    pred = rng.standard_normal((n, 3, 256))
    pred[:, :, 60:120] *= 4
    return dict(pred=pred, target=pred + 0.3 * rng.standard_normal((n, 3, 256)),
                cond_signal=rng.standard_normal((n, 3, 256)), mag=rng.uniform(4.1, 9.0, n),
                dist=rng.uniform(1, 199, n), im_gen=np.exp(rng.standard_normal(n)),
                im_obs=np.exp(rng.standard_normal(n)))


def figure_data(fig) -> list:
    """What a figure shows: per axes its title, labels, lines, images and texts."""
    out = []
    for ax in fig.axes:
        out.append(("axes", ax.get_title(), ax.get_xlabel(), ax.get_ylabel()))
        out += [("line", line.get_label(), line.get_color(), line.get_xydata())
                for line in ax.get_lines()]
        out += [("image", np.ma.filled(np.ma.asarray(im.get_array(), np.float64), np.nan))
                for im in ax.get_images()]
        out += [("text", t.get_text(), np.asarray(t.get_position(), np.float64))
                for t in ax.texts]
    return out


def assert_same_figure(got, want):
    got, want = figure_data(got), figure_data(want)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g[0] == w[0] and len(g) == len(w)
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
                peak = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 0.0
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * peak, equal_nan=True)
            else:
                assert a == b


def _tensors(kwargs):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) and v.dtype != object else v
            for k, v in kwargs.items()}


PLOTS = {
    "sample-with-target": lambda m, mm: (m.SamplePlot(plot_target=True, fs=100, channel=0),
                                         ("pred", "target"), ()),
    "sample-channel-2": lambda m, mm: (m.SamplePlot(fs=100, channel=2, n=3), ("pred",), ()),
    "upsampling": lambda m, mm: (m.UpsamplingSamplePlot(fs=100, channel=1),
                                 ("pred", "target", "cond_signal"), ()),
    "asd": lambda m, mm: (m.AmplitudeSpectralDensityPlot(fs=100, channel=2),
                          ("pred", "target"), ()),
    "bin-mse": lambda m, mm: (m.BinPlot(mm.MeanSquaredError(channel=0), MAG_BINS, DIST_BINS),
                              ("pred", "target"), ("mag", "dist")),
    "bin-asd": lambda m, mm: (m.BinPlot(mm.AmplitudeSpectralDensity(fs=100, channel=1),
                                        MAG_BINS, DIST_BINS, fmt=".3g"),
                              ("pred", "target"), ("mag", "dist")),
    "envelope-grid": lambda m, mm: (m.MovingAverageEnvelopeGrid(100, 0, MAG_BINS, DIST_BINS,
                                                                window_size=16),
                                    ("pred", "target"), ("mag", "dist")),
    "asd-grid": lambda m, mm: (m.AmplitudeSpectralDensityGrid(100, 2, MAG_BINS, DIST_BINS),
                               ("pred", "target"), ("mag", "dist")),
    "gallery": lambda m, mm: (m.WaveformGalleryGrid(fs=100, channel=0, samples_per_event=4),
                              ("pred", "target"), ()),
    "likelihood": lambda m, mm: (m.CumulativeProbabilityPlot(MAG_BINS, DIST_BINS),
                                 ("im_gen", "im_obs"), ("mag", "dist")),
    "likelihood-gmm": lambda m, mm: (m.CumulativeProbabilityPlot(MAG_BINS, DIST_BINS, "PGV"),
                                     ("im_gen", "im_obs"), ("mag", "dist", "gmm_matrix")),
}


@pytest.mark.parametrize("case", list(PLOTS))
def test_plot_matches_jax(data, case):
    """One figure built by each package on the same inputs; the port's name
    is the JAX one's."""
    data = dict(data, gmm_matrix=np.linspace(0.1, 1.0, 9).reshape(3, 3))
    if case == "gallery":  # 3 events of 4 samples each against 3 observed traces
        data = dict(data, pred=data["pred"][:12], target=data["target"][:3])
    jplot, args, aux = PLOTS[case](JP, JM)
    pplot, _, _ = PLOTS[case](PP, PM)
    assert pplot.name == jplot.name
    kw = {k: data[k] for k in aux}
    if case == "gallery":
        kw["event_labels"] = ["M5.0 40 km", "M6.2 110 km", "M7.1 20 km"]
    want = jplot(*(data[a] for a in args), **kw)
    got = pplot(*(torch.from_numpy(data[a]) for a in args), **_tensors(kw))
    assert_same_figure(got, want)


def test_lognormal_likelihood_matrix_matches_jax(data, rng):
    gen_mag, gen_dist = rng.uniform(4.1, 9.0, 24), rng.uniform(1, 199, 24)
    for kw in ({}, {"gen_mag": gen_mag, "gen_dist": gen_dist}, {"min_count": 1}):
        want = JP.lognormal_likelihood_matrix(data["im_obs"], data["im_gen"], data["mag"],
                                              data["dist"], MAG_BINS, DIST_BINS, **kw)
        got = PP.lognormal_likelihood_matrix(torch.from_numpy(data["im_obs"]), data["im_gen"],
                                             data["mag"], data["dist"], MAG_BINS, DIST_BINS, **kw)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)


def test_report_figures_match_jax(tmp_path, data, capsys, monkeypatch):
    """The port's ``report_figures`` writes the JAX version's seven files, and
    the report CLI's ``--figures`` calls it after the report."""
    path = tmp_path / "eval-rank_0.h5"
    with h5py.File(path, "w") as f:
        f["predicted_waveform"] = data["pred"].astype(np.float32)
        f["target_waveform"] = data["target"].astype(np.float32)
        f["magnitude"] = data["mag"]
        f["hypocentral_distance"] = data["dist"]
    want = jreport.report_figures([path], tmp_path / "jax", mag_bins=MAG_BINS,
                                  dist_bins=DIST_BINS)
    got = preport.report_figures([path], tmp_path / "port", mag_bins=MAG_BINS,
                                 dist_bins=DIST_BINS)
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 7
    assert all(p.stat().st_size > 0 for p in got)
    # the report CLI's --figures renders the same set (the default bins) after the report
    drawn = []
    monkeypatch.setattr(preport, "report_figures",
                        lambda files, outdir: drawn.append((files, outdir)) or got)
    preport.main([str(path), "--figures", str(tmp_path / "cli")])
    assert drawn == [([str(path)], str(tmp_path / "cli"))]
    assert capsys.readouterr().out.count("wrote") == 7


# ---- the sampling-eval callback ------------------------------------------------------


def _batches(rng, n_batches=2, n=12, channels=3):
    out = []
    for _ in range(n_batches):
        raw = np.stack([rng.uniform(1, 199, n), rng.uniform(4.1, 9.0, n),
                        rng.uniform(200, 800, n), rng.uniform(2, 60, n),
                        rng.uniform(10, 300, n)], axis=1)
        out.append({"signal": rng.standard_normal((n, 256, channels)).astype(np.float32),
                    "waveform": rng.standard_normal((n, 256, 3)).astype(np.float32),
                    "cond": ((raw - STATS[:, 0]) / STATS[:, 1]).astype(np.float32)})
    return out


class _Trainer:
    """What the callback reads of a trainer."""

    def __init__(self, workdir, writer):
        self.workdir, self.writer, self.device = workdir, writer, torch.device("cpu")


class _State:
    ema_params = {}
    ema = "the EMA module"


def _pair(tmp_path, batches, rep, jax_sample=None, port_sample=None, **kw):
    """The JAX callback and the port's over the same batches and arguments
    (the metrics and plots from each package's own modules)."""
    jax_sample = jax_sample or (lambda params, key, batch: batch["signal"] * 0.5)
    port_sample = port_sample or (lambda model, gen, batch: batch["signal"] * 0.5)
    made = {}
    for name, M, P, cb, sample, wrap, writer in (
            ("jax", JM, JP, JaxCallback, jax_sample, lambda b: b, JaxWriter),
            ("port", PM, PP, SamplingEvalCallback, port_sample,
             lambda b: {k: torch.from_numpy(v) for k, v in b.items()}, MetricWriter)):
        args = {k: v(M, P) if callable(v) else v for k, v in kw.items()}
        workdir = tmp_path / name
        workdir.mkdir()
        made[name] = (cb(sample, [wrap(b) for b in batches], rep[name], **args),
                      _Trainer(workdir, writer(workdir)))
    return made


def _rows(trainer):
    return [json.loads(line) for line in (trainer.workdir / "metrics.jsonl").open()]


def _metrics(M, P):
    return [M.AmplitudeSpectralDensity(fs=100, channel=c, isotropic=True) for c in range(3)] + [
        M.MeanSquaredError(channel=0)]


def _plots(M, P):
    return [P.SamplePlot(plot_target=True, fs=100, channel=0),
            P.BinPlot(M.AmplitudeSpectralDensity(fs=100, channel=0, isotropic=True), MAG_BINS,
                      DIST_BINS),
            P.MovingAverageEnvelopeGrid(100, 0, MAG_BINS, DIST_BINS, window_size=16)]


REPS = {"identity": (lambda: {"jax": jrep.Identity(), "port": prep.Identity()}, 3),
        "envelope": (lambda: {"jax": jrep.MovingAverageEnvelope(window_size=16),
                              "port": prep.MovingAverageEnvelope(window_size=16)}, 6)}


@pytest.mark.parametrize("rep", list(REPS))
def test_callback_matches_jax(tmp_path, rng, rep):
    """The same scalars at the same step, the same figure names under
    ``plots/epoch_{e}``; each batch's generator seeded ``fold_seed(123,
    epoch * 1000 + i)`` and given the EMA module."""
    make, channels = REPS[rep]
    batches = _batches(rng, channels=channels)
    seen = []

    def port_sample(model, gen, batch):
        seen.append((model, gen.initial_seed()))
        return batch["signal"] * 0.5

    plots = {"plots": _plots} if rep == "identity" else {}
    made = _pair(tmp_path, batches, make(), port_sample=port_sample, metrics=_metrics,
                 every_n_epochs=2, feature_stats=STATS, features_keys=KEYS, **plots)
    for name, (cb, trainer) in made.items():
        cb(trainer, _State(), epoch=3, gstep=40)
    jt, pt = made["jax"][1], made["port"][1]
    (want,), (got,) = _rows(jt), _rows(pt)
    assert set(got) == set(want) and len(got) == 5 and got["step"] == 40
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    assert seen == [("the EMA module", fold_seed(123, 3000 + i)) for i in range(2)]
    if plots:
        names = sorted(p.name for p in (jt.workdir / "plots" / "epoch_3").iterdir())
        assert sorted(p.name for p in (pt.workdir / "plots" / "epoch_3").iterdir()) == names
        assert len(names) == 3


def test_callback_nan_guard_matches_jax(tmp_path, rng, caplog):
    """A sample with a NaN row is warned about and zeroed, then scored as the JAX one's."""
    batches = _batches(rng)

    def with_nan(batch):
        out = np.array(batch["signal"]) * 0.5
        out[1] = np.nan
        return out

    made = _pair(tmp_path, batches, REPS["identity"][0](), metrics=_metrics,
                 jax_sample=lambda p, k, b: with_nan(b),
                 port_sample=lambda m, g, b: torch.from_numpy(with_nan(b)), every_n_epochs=1)
    with caplog.at_level(logging.WARNING, logger="tqdne_tpu_torch"):
        made["port"][0](made["port"][1], _State(), epoch=0, gstep=1)
    assert "NaN guard" in caplog.text
    made["jax"][0](made["jax"][1], _State(), epoch=0, gstep=1)
    (want,), (got,) = _rows(made["jax"][1]), _rows(made["port"][1])
    for key in want:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


def test_callback_failure_counter_and_batch_size_match_jax(tmp_path, rng):
    """A metric failing in a row raises at the third failure, a success
    resets the count; a sample function that drops rows raises, in both."""
    batches = _batches(rng, n_batches=1)
    schedule = [True, True, False, True, True, True]

    class Flaky:
        name = "Flaky"

        def __init__(self):
            self.calls = 0

        def __call__(self, pred, target):
            self.calls += 1
            if schedule[self.calls - 1]:
                raise ValueError("boom")
            return 0.0

    made = _pair(tmp_path, batches, REPS["identity"][0](), metrics=lambda M, P: [Flaky()],
                 every_n_epochs=1, max_consecutive_failures=3)
    for cb, trainer in made.values():
        for epoch in range(5):
            cb(trainer, _State(), epoch=epoch, gstep=epoch)
        with pytest.raises(RuntimeError, match="3 sampling evals in a row"):
            cb(trainer, _State(), epoch=5, gstep=5)
    (tmp_path / "bad").mkdir()
    bad = _pair(tmp_path / "bad", batches, REPS["identity"][0](), every_n_epochs=1,
                jax_sample=lambda p, k, b: b["signal"][:5],
                port_sample=lambda m, g, b: b["signal"][:5])
    for cb, trainer in bad.values():
        with pytest.raises(ValueError, match="must preserve batch size"):
            cb(trainer, _State(), epoch=0, gstep=1)


def test_callback_runs_on_its_period(tmp_path, rng):
    made = _pair(tmp_path, _batches(rng, n_batches=1), REPS["identity"][0](), metrics=_metrics,
                 every_n_epochs=3)
    for cb, trainer in made.values():
        for epoch in range(6):
            cb(trainer, _State(), epoch=epoch, gstep=10 * epoch)
    assert [r["step"] for r in _rows(made["port"][1])] == [r["step"] for r in
                                                           _rows(made["jax"][1])] == [20, 50]


# ---- the Trainer's callbacks ---------------------------------------------------------------


class _Loader:
    epoch = 0

    def __init__(self, n):
        self.batches = [{"x": torch.full((2, 2), float(i))} for i in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_trainer_calls_callbacks_after_validation_before_checkpoint(tmp_path):
    model = torch.nn.Linear(2, 2)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))

    def train_step(st, batch, generator=None):
        st.step += 1
        return {"loss": batch["x"].mean()}

    def eval_step(st, batch, generator=None):
        return {"loss": batch["x"].mean()}

    calls = []

    def callback(trainer, st, epoch, gstep):
        rows = [json.loads(line) for line in trainer.writer.path.open()]
        saved = (trainer.workdir / "checkpoints" / "last" / f"{gstep}.pt").exists()
        calls.append((epoch, gstep, "validation/loss" in rows[-1], saved, st is state))

    trainer = Trainer(train_step, eval_step, tmp_path, device="cpu", max_epochs=3,
                      callbacks=[callback])
    trainer.fit(state, _Loader(2), _Loader(1), resume=False)
    assert calls == [(e, 2 * (e + 1), True, False, True) for e in range(3)]
    assert (tmp_path / "checkpoints" / "last" / "6.pt").exists()


# ---- the train CLI ---------------------------------------------------------------------------


def jax_cli_plot_names() -> list[str]:
    """The file names of the JAX train CLI's figures for a conditional recipe
    (``tqdne_tpu/cli/train.py``'s list, built from the JAX classes)."""
    fs, bins = 100, (jconfigs.MAG_BINS, jconfigs.DIST_BINS)
    plots = [JP.SamplePlot(plot_target=True, fs=fs, channel=c) for c in range(3)]
    plots += [JP.AmplitudeSpectralDensityPlot(fs=fs, channel=c) for c in range(3)]
    plots += [JP.BinPlot(JM.AmplitudeSpectralDensity(fs=fs, channel=0, isotropic=True), *bins),
              JP.MovingAverageEnvelopeGrid(fs, 0, *bins),
              JP.AmplitudeSpectralDensityGrid(fs, 0, *bins)]
    return sorted(f"{p.name.replace(' ', '_')}.png" for p in plots)


@pytest.mark.parametrize("recipe", ["latent_edm", "consistency", "ddpm"])
def test_train_cli_eval_every(tmp_path, monkeypatch, recipe):
    """One step with ``--eval-every 1``: the callback samples the first two
    validation batches at the epoch's end, writes the isotropic ASD of each
    channel and the JAX CLI's figures (DDPM at 2 timesteps)."""
    wd = str(tmp_path)
    run = ["--workdir", wd, "--tiny", "--device", "cpu", "-b", "2", "--synthetic", "24",
           "--dtype", "f32", "--max-steps", "1", "--eval-every", "1"]
    if recipe == "latent_edm":
        train_cli.main(["autoencoder", *run])
    monkeypatch.setattr(ddpm, "DDPMConfig", functools.partial(ddpm.DDPMConfig,
                                                              num_train_timesteps=2))
    train_cli.main([recipe, *run])
    out = tmp_path / "outputs" / common.RECIPES[recipe].name
    rows = [json.loads(line) for line in (out / "metrics.jsonl").open()]
    evals = [r for r in rows if any(k.startswith("eval/") for k in r)]
    assert len(evals) == 1 and evals[0]["step"] == 1
    assert sorted(k for k in evals[0] if k != "step") == [
        f"eval/AmplitudeSpectralDensity - Channel {c}" for c in range(3)]
    assert all(np.isfinite(v) for v in evals[0].values())
    assert sorted(p.name for p in (out / "plots" / "epoch_0").iterdir()) == jax_cli_plot_names()


DIFFUSION = [k for k, r in common.RECIPES.items() if r.kind in common.SAMPLED_KINDS]


@pytest.mark.parametrize("recipe", DIFFUSION)
def test_eval_sampler_takes_the_jax_defaults(monkeypatch, recipe):
    """Each of the nine diffusion recipes' (the JAX package's eight and the
    port's ``latent_dit``) callback samples with its kind's
    sampler at the JAX step factories' defaults: EDM Heun at 25 steps, one
    eval from sigma_max and one refinement at sigma 1, DDPM's ``DDPMConfig``;
    with a latent recipe's autoencoder."""
    assert len(DIFFUSION) == 9
    kind = common.RECIPES[recipe].kind
    jax_defaults = {
        "edm": inspect.signature(jsteps.make_edm_steps).parameters["num_sampling_steps"].default,
        "consistency": inspect.signature(jcons.consistency_sample).parameters["sigmas"].default}
    assert inspect.signature(psteps.sample_edm).parameters["num_steps"].default == \
        jax_defaults["edm"] == 25
    assert inspect.signature(cons.sample_consistency).parameters["sigmas"].default == \
        jax_defaults["consistency"] == (1.0,)
    called = []

    def recorder(name):
        def fn(*args, **kw):
            called.append((name, args, kw))
            return torch.zeros(3, 4)
        return fn

    for name in ("sample_edm", "sample_consistency", "sample_distilled"):
        monkeypatch.setattr(train_cli, name, recorder(name))
    monkeypatch.setattr(ddpm, "ddpm_sample", recorder("ddpm_sample"))
    gen, ae = torch.Generator(), object()
    sample = train_cli.eval_sampler(kind, ae if kind != "ddpm" else None, (8, 6), "cpu")
    sample("model", gen, {"cond": torch.ones(3, 5), "waveform": torch.zeros(3, 8, 3)})
    (name, args, kw), = called
    want = {"edm": "sample_edm", "consistency": "sample_consistency",
            "distill": "sample_distilled", "ddpm": "ddpm_sample"}[kind]
    assert name == want and kw["generator"] is gen
    if kind == "ddpm":
        assert args[1:3] == ("model", (3, 8, 6)) and kw["cond"].shape == (3, 5)
        assert args[0].num_train_timesteps == 1000
    else:
        assert args[:2] == ("model", (3, 8, 6)) and args[2].shape == (3, 5)
        assert kw["autoencoder"] is ae and set(kw) == {"generator", "device", "autoencoder"}
