"""The port's evaluation path against the JAX package on the CPU: the
conditioning classifier with the committed trained weights (f32 and bf16),
the metrics, FID and IS through both classifiers, ``Dataset.get_feature``,
the evaluate CLI's HDF5 layout and the report over its files.

The JAX classifier takes its default route: its 256-token attention goes
through the Pallas flash kernel, in interpret mode on the CPU.
Tolerance: f32 rtol 1e-4 / atol 1e-4 for the trained stacks.
"""

import json
import math
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_generate import tiny_flagship  # noqa: F401 - a fixture
from tqdne_tpu import configs as jconfigs
from tqdne_tpu.cli.export_weights import load_exported
from tqdne_tpu.data.dataset import Dataset as JaxDataset
from tqdne_tpu.data.representation import LogSpectrogram as JaxLogSpectrogram
from tqdne_tpu.eval import metrics as jmetrics
from tqdne_tpu.eval.report import evaluation_report as jax_evaluation_report
from tqdne_tpu.models.classifier import Classifier as JaxClassifier
from tqdne_tpu.models.classifier import weighted_cross_entropy as jax_weighted_ce
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import evaluate as evaluate_cli
from tqdne_tpu_torch.data.dataset import ArrayDataset, Dataset, make_synthetic_dataset, \
    synthetic_arrays
from tqdne_tpu_torch.data.representation import LogSpectrogram
from tqdne_tpu_torch.eval import metrics
from tqdne_tpu_torch.eval.report import evaluation_report, read_eval_files, report_from_arrays
from tqdne_tpu_torch.models.classifier import Classifier, weighted_cross_entropy
from tqdne_tpu_torch.utils import randomize_
from tqdne_tpu_torch.utils.convert import convert_file, read_manifest

RTOL, ATOL = 1e-4, 1e-4
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
CLF_WEIGHTS = WEIGHTS / "Classifier-LogSpectrogram-ema.msgpack"
CLF_MANIFEST = WEIGHTS / "Classifier-LogSpectrogram-ema.manifest.json"
# the JAX evaluate CLI's datasets (tqdne_tpu/cli/evaluate.py:194-209)
EVAL_DATASETS = {"target_waveform", "predicted_waveform", "target_signal", "predicted_signal",
                 "target_classifier_embedding", "predicted_classifier_embedding",
                 "target_classifier_pred", "predicted_classifier_pred"}
# the provenance keys the JAX evaluate CLI always writes
PROVENANCE_KEYS = {"run_name", "recipe", "num_steps", "solver", "seed", "dtype", "split",
                   "consistency_noise", "refine_sigma"}


@pytest.fixture(scope="module")
def trained_classifier(tmp_path_factory):
    """The committed trained classifier on both sides: JAX through the
    package's own loader, the port through the converter CLI's ``.pt`` and
    ``cli.evaluate.load_classifier`` with the artifact's manifest."""
    params, manifest = load_exported(str(CLF_WEIGHTS))
    hp = manifest["hparams"]
    enc = {k: tuple(v) if isinstance(v, list) else v for k, v in hp["encoder"].items()}
    pt = tmp_path_factory.mktemp("classifier") / "classifier.pt"
    convert_file(CLF_WEIGHTS, pt)
    return enc, hp["num_classes"], params, pt


def test_manifest_and_weights_load_strictly(trained_classifier):
    *_, pt = trained_classifier
    hparams = read_manifest(CLF_MANIFEST)
    assert hparams["num_classes"] == 36 == configs.SpectrogramClassificationConfig().num_classes
    assert hparams["encoder"] == configs.get_classifier_encoder_config(
        configs.SpectrogramClassificationConfig())
    model = Classifier(hparams["encoder"], hparams["num_classes"])
    model.load_state_dict(torch.load(pt, weights_only=True))  # strict
    assert sum(p.numel() for p in model.parameters()) == 7_171_300


def _spectrograms(rng, n=2):
    return rng.uniform(-1, 1, (n, 128, 128, 3)).astype(np.float32)


def test_classifier_matches_jax_with_trained_weights(rng, trained_classifier):
    enc, num_classes, params, pt = trained_classifier
    x = _spectrograms(rng)
    jm = JaxClassifier(encoder_config=enc, num_classes=num_classes)
    want_emb = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, method="embed"))(params, x))
    want_logits = np.asarray(jax.jit(jm.apply)(params, x))
    port = evaluate_cli.load_classifier(pt, CLF_MANIFEST, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        emb, logits = port.embed_and_logits(torch.from_numpy(x))
        alone = port(torch.from_numpy(x))
    assert emb.shape == (2, 256) and logits.shape == (2, 36) and emb.dtype == torch.float32
    np.testing.assert_allclose(emb.numpy(), want_emb, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(alone, logits, rtol=0, atol=0)


def test_classifier_bf16_matches_jax_bf16(rng, trained_classifier):
    """bf16 compute over f32 parameters on both sides.  The frameworks round
    bf16 products in different orders, so the bound is 2% of the peak."""
    enc, num_classes, params, pt = trained_classifier
    x = _spectrograms(rng)
    jm = JaxClassifier(encoder_config=enc, num_classes=num_classes, dtype=jnp.bfloat16)
    want_emb = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, method="embed"))(params, x))
    want_logits = np.asarray(jax.jit(jm.apply)(params, x))
    port = evaluate_cli.load_classifier(pt, CLF_MANIFEST, dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        emb, logits = port.embed_and_logits(torch.from_numpy(x))
    assert emb.dtype == logits.dtype == torch.float32
    for got, want in ((emb, want_emb), (logits, want_logits)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.02 * np.abs(want).max())


def test_weighted_cross_entropy_matches_jax(rng):
    logits = rng.standard_normal((8, 36)).astype(np.float32)
    labels = rng.integers(0, 36, 8)
    weights = rng.uniform(0.5, 2.0, 36).astype(np.float32)
    want = float(jax_weighted_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weights)))
    got = weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(weights)).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_host_metrics_match_jax(rng):
    x = rng.standard_normal((40, 6)) * [1, 2, 3, 1, 1, 0.5]
    y = rng.standard_normal((40, 6)) + 0.3
    for iso in (False, True):
        assert metrics.frechet_distance(x, y, iso) == pytest.approx(
            jmetrics.frechet_distance(x, y, iso), rel=1e-9)
    pred = rng.standard_normal((16, 3, 512)).astype(np.float32)
    target = rng.standard_normal((16, 3, 512)).astype(np.float32) * 2
    for c in range(3):
        for iso in (False, True):
            got = metrics.AmplitudeSpectralDensity(100, c, isotropic=iso)(pred, target)
            want = jmetrics.AmplitudeSpectralDensity(100, c, isotropic=iso)(pred, target)
            assert got == pytest.approx(want, rel=1e-9)
        assert metrics.MeanSquaredError(c)(pred, target) == pytest.approx(
            jmetrics.MeanSquaredError(c)(pred, target), rel=1e-9)
    assert metrics.MeanSquaredError(None)(pred, target) == pytest.approx(
        jmetrics.MeanSquaredError(None)(pred, target), rel=1e-9)
    assert metrics.asd_loss(pred, target) == pytest.approx(jmetrics.asd_loss(pred, target),
                                                           rel=1e-9)


class _FixedLogits(torch.nn.Module):
    """A stand-in classifier whose logits are given rows of a table."""

    def __init__(self, table):
        super().__init__()
        self.table = torch.nn.Parameter(torch.from_numpy(table), requires_grad=False)
        self.calls = 0

    def forward(self, x):
        rows = self.table[self.calls: self.calls + len(x)]
        self.calls += len(x)
        return rows


def test_inception_score_matches_jax(rng):
    """IS on the same logits: the port's metric over a stand-in classifier
    that returns them batch by batch, against the JAX metric's statistics
    over the same rows."""
    logits = (rng.standard_normal((10, 36)) * 3).astype(np.float32)
    waves = rng.standard_normal((10, 3, 4064)).astype(np.float32)
    got = metrics.InceptionScore(_FixedLogits(logits), LogSpectrogram(hop_size=32),
                                 batch_size=4)(waves)
    jmetric = object.__new__(jmetrics.InceptionScore)  # its statistics, without a model
    jmetric._signals, jmetric._logits = (lambda w: w), None
    jmetric._batched = lambda fn, x: logits
    assert got == pytest.approx(jmetric(waves), rel=1e-9)


def test_fid_and_is_through_both_classifiers_match_jax(rng, trained_classifier):
    """FID and IS end to end: waveforms -> log-spectrograms -> each package's
    trained classifier (f32) -> the statistics, to 1e-3 relative."""
    enc, num_classes, params, pt = trained_classifier
    t = np.linspace(0, 1, 4064, dtype=np.float32)
    pred = (rng.standard_normal((6, 3, 4064)) * np.exp(-3 * t)).astype(np.float32)
    target = (rng.standard_normal((6, 3, 4064)) * np.exp(-5 * t) * 2).astype(np.float32)
    port = evaluate_cli.load_classifier(pt, CLF_MANIFEST, dtype=torch.float32, device="cpu")
    rep = LogSpectrogram(hop_size=32)
    jm = JaxClassifier(encoder_config=enc, num_classes=num_classes)
    jrep = JaxLogSpectrogram(hop_size=32)
    got = (metrics.FrechetInceptionDistance(port, rep, batch_size=4)(pred, target),
           metrics.InceptionScore(port, rep, batch_size=4)(pred))
    want = (jmetrics.FrechetInceptionDistance(jm, params, jrep, batch_size=4)(pred, target),
            jmetrics.InceptionScore(jm, params, jrep, batch_size=4)(pred))
    assert all(math.isfinite(v) for v in got) and got[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_get_feature_matches_jax(tmp_path):
    path = make_synthetic_dataset(tmp_path / "data.h5", n=24, t=4064)
    port = Dataset(path, LogSpectrogram(hop_size=32), cut=4064, cond=True, split="test")
    ref = JaxDataset(path, JaxLogSpectrogram(hop_size=32), cut=4064, cond=True, split="test")
    arrays = ArrayDataset(synthetic_arrays(24, t=4064), LogSpectrogram(hop_size=32), cut=4064,
                          cond=True, split="test")
    for key in configs.FEATURES_KEYS:
        want = ref.get_feature(key)
        assert want.shape == (len(ref),)
        np.testing.assert_array_equal(port.get_feature(key), want)
        np.testing.assert_array_equal(arrays.get_feature(key), want)
    port.close()
    ref.close()


TINY_CLASSIFIER = {"in_channels": 3, "model_channels": 16, "out_channels": 32,
                   "channel_mult": [1, 2, 4, 4], "attention_resolutions": [8],
                   "num_res_blocks": 1, "dims": 2, "conv_kernel_size": 3, "num_heads": 4,
                   "dropout": 0.1}


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory, tiny_flagship):  # noqa: F811 - the imported fixture
    """The evaluate CLI over a synthetic dataset with the tiny flagship and a
    tiny random classifier (16 channels, given by its manifest)."""
    *_, paths = tiny_flagship
    work = tmp_path_factory.mktemp("evaluate")
    config = configs.LatentSpectrogramConfig(workdir=work)
    make_synthetic_dataset(config.datapath, n=12, t=4064)
    manifest = work / "clf.manifest.json"
    manifest.write_text(json.dumps({"hparams": {"encoder": TINY_CLASSIFIER, "kind": "classifier",
                                                "num_classes": 36}}))
    clf = randomize_(Classifier(read_manifest(manifest)["encoder"], 36), 5)
    torch.save(clf.state_dict(), work / "clf.pt")
    evaluate_cli.main([
        "--workdir", str(work), "--split", "full", "-b", "5", "--unet-weights",
        str(paths["unet"]), "--ae-weights", str(paths["ae"]), "--classifier-weights",
        str(work / "clf.pt"), "--classifier-manifest", str(manifest), "--num-steps", "2",
        "--solver", "dpmpp_2m", "--dtype", "f32", "--tiny", "--device", "cpu",
        "--suffix=-nfe2"])
    return work, sorted((work / "evaluation").glob("*.h5"))


def test_evaluate_cli_writes_the_jax_layout(evaluated):
    work, files = evaluated
    assert [f.name for f in files] == [
        "Latent-EDM-32x32x8-LogSpectrogram-nfe2-split_full-rank_0.h5"]
    with h5py.File(files[0]) as f:
        assert set(f) == set(jconfigs.LatentSpectrogramConfig().features_keys) | EVAL_DATASETS
        shapes = {k: f[k].shape for k in f}
        provenance = json.loads(f.attrs["provenance"])
        features = {k: f[k][:] for k in configs.FEATURES_KEYS}
        waves = f["predicted_waveform"][:]
    assert shapes["target_waveform"] == shapes["predicted_waveform"] == (12, 3, 4064)
    assert shapes["target_signal"] == shapes["predicted_signal"] == (12, 3, 128, 128)
    assert shapes["target_classifier_embedding"] == shapes["predicted_classifier_embedding"] \
        == (12, 32)
    assert shapes["target_classifier_pred"] == shapes["predicted_classifier_pred"] == (12, 36)
    assert all(shapes[k] == (12,) for k in configs.FEATURES_KEYS)
    assert PROVENANCE_KEYS <= set(provenance)
    assert provenance["num_steps"] == 2 and provenance["solver"] == "dpmpp_2m"
    assert np.isfinite(waves).all() and np.abs(waves).max() > 0
    ref = JaxDataset(work / "data" / "preprocessed_waveforms.h5",
                     JaxLogSpectrogram(hop_size=32), split="full")
    for key, values in features.items():
        np.testing.assert_array_equal(values, ref.get_feature(key))
    ref.close()


def _assert_reports_equal(got, want, path="report"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_reports_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_reports_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12), path
    else:
        assert got == want, path


def test_report_over_evaluate_files_matches_jax(evaluated):
    _, files = evaluated
    bins = dict(mag_bins=(4, 6, 9.1), dist_bins=(0, 100, 200), min_bin_count=2)
    want = jax_evaluation_report(files, **bins, calibration_files=files)
    got = evaluation_report(files, **bins, calibration_files=files)
    assert want["fid_calibration"] == pytest.approx(0.0, abs=1e-6)
    assert math.isfinite(want["fid"]) and math.isfinite(want["inception_score"])
    _assert_reports_equal(got, want)
    # the in-memory entry point the GPU run takes gives the same report
    arrays, provenance = read_eval_files(files)
    _assert_reports_equal(report_from_arrays(arrays, **bins, provenance=provenance),
                          jax_evaluation_report(files, **bins))
    _assert_reports_equal(evaluation_report(files), jax_evaluation_report(files))
