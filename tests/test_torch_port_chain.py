"""The port's flagship training chain against the JAX package on the CPU:
``ClassificationDataset`` and ``CachedLatentsDataset`` over one HDF5 file
(and the same columns in memory), ``DeviceResidentLoader`` against
``BatchLoader``, the precomputed latent moments against JAX's
``tqdne-precompute-latents`` from the same converted autoencoder with the
fingerprint refusal, and the train CLI's chain: ``autoencoder --tiny``,
``latent_edm`` reading that run, ``precompute_latents``, ``latent_edm
--cached-latents`` and ``classifier --tiny``, whose run the evaluate CLI's
loader reads.  Tolerance: f32 rtol 1e-4 / atol 1e-5.
"""

import argparse
import json

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tqdne_tpu import configs as jconfigs
from tqdne_tpu.cli import common as jcommon
from tqdne_tpu.cli import precompute_latents as jax_precompute
from tqdne_tpu.data import dataset as jdataset
from tqdne_tpu.data.representation import Identity as JaxIdentity
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import evaluate as evaluate_cli
from tqdne_tpu_torch.cli import precompute_latents
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.data.dataset import (
    CachedLatentsDataset,
    ClassificationDataset,
    synthetic_arrays,
)
from tqdne_tpu_torch.data.pipeline import BatchLoader, DeviceResidentLoader
from tqdne_tpu_torch.data.representation import Identity
from tqdne_tpu_torch.utils import convert

RTOL, ATOL = 1e-4, 1e-5
N = 20


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 20-row synthetic dataset file (the JAX writer) with random latent
    moments beside it, and the same columns in memory."""
    root = tmp_path_factory.mktemp("chain")
    path = jdataset.make_synthetic_dataset(root / "d.h5", n=N, t=1024, seed=3)
    rng = np.random.default_rng(3)
    latents = {k: rng.standard_normal((N, 4, 4, 2)).astype(np.float32)
               for k in ("latent_mean", "latent_log_std")}
    with h5py.File(root / "lat.h5", "w") as f:
        for k, v in latents.items():
            f.create_dataset(k, data=v)
    return path, root / "lat.h5", synthetic_arrays(N, t=1024, seed=3), latents


def test_classification_dataset_matches_jax(data):
    """Labels, class weights and a batch over the HDF5 file, split
    ``train_validation``, against JAX; the in-memory dataset equals it."""
    path, _, arrays, _ = data
    bins = configs.MAG_BINS, configs.DIST_BINS
    want = jdataset.ClassificationDataset(path, JaxIdentity(), *bins, split="train_validation")
    got = ClassificationDataset(path, Identity(), *bins, split="train_validation")
    in_memory = ClassificationDataset(arrays, Identity(), *bins, split="train_validation")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.get_class_weights(), want.get_class_weights())
    np.testing.assert_array_equal(in_memory.get_class_weights(), want.get_class_weights())
    idx = np.array([4, 0, 7])
    want_batch = want.load_batch(idx, keys=("signal", "label"))
    for ds in (got, in_memory):
        batch = ds.load_batch(idx, keys=("signal", "label"))
        assert set(batch) == set(want_batch) == {"signal", "label"}
        for k in batch:
            np.testing.assert_array_equal(batch[k], want_batch[k], err_msg=k)
    assert got.load_batch(idx, keys=("label",)).keys() == {"label"}  # no waveform read


def test_cached_latents_dataset_matches_jax(data):
    """Moments and conditioning without a waveform read, against JAX, from
    the files and from memory; a latents table of another row count is
    refused."""
    path, lat_path, arrays, latents = data
    keys = ("latent_mean", "latent_log_std", "cond")
    want = jdataset.CachedLatentsDataset(path, lat_path, JaxIdentity(), cond=True)
    idx = np.array([5, 1, 9, 2])
    want_batch = want.load_batch(idx, keys=keys)
    for ds in (CachedLatentsDataset(path, lat_path, Identity(), cond=True),
               CachedLatentsDataset(arrays, latents, Identity(), cond=True)):
        batch = ds.load_batch(idx, keys=keys)
        assert set(batch) == set(want_batch) == set(keys)
        for k in keys:
            np.testing.assert_array_equal(batch[k], want_batch[k], err_msg=k)
    short = {k: v[:-1] for k, v in latents.items()}
    with pytest.raises(ValueError, match="19 rows but the dataset has 20"):
        CachedLatentsDataset(arrays, short, Identity())


def test_device_resident_loader_equals_batch_loader(data):
    """Batch for batch over two epochs, the second set as the Trainer sets
    it on a resume; ``fits`` holds the columns to the byte budget."""
    _, _, arrays, latents = data
    keys = ("latent_mean", "latent_log_std", "cond")
    ds = CachedLatentsDataset(arrays, latents, Identity(), split="full")
    resident = DeviceResidentLoader(ds, 6, keys=keys, seed=4, device="cpu")
    host = BatchLoader(ds, 6, keys=keys, seed=4, device="cpu", prefetch=0)
    assert len(resident) == len(host) == 3
    for epoch in (0, 5):
        resident.epoch = host.epoch = epoch
        for a, b in zip(resident, host, strict=True):
            assert a.keys() == b.keys() == set(keys)
            for k in keys:
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    per_row = 2 * 4 * 4 * 2 * 4 + 5 * 4
    assert DeviceResidentLoader.fits(ds, keys, budget_bytes=per_row * N)
    assert not DeviceResidentLoader.fits(ds, keys, budget_bytes=per_row * N - 1)


def _tiny_ae_weights(workdir):
    """Seeded random weights of the --tiny flagship autoencoder, as a flax
    tree and converted to a ``.pt`` state dict."""
    config = jconfigs.LatentSpectrogramConfig(workdir=str(workdir))
    ae, _, _ = jcommon.build_autoencoder(config, 2, model_channels=32)
    shapes = jax.eval_shape(lambda: ae.init({"params": jax.random.key(0),
                                             "sample": jax.random.key(0)},
                                            jnp.zeros((1, 128, 128, 3))))
    gen = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(gen.standard_normal(s.shape).astype(np.float32) * 0.02), shapes)
    sd = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    torch.save(sd, workdir / "ae.pt")
    return params, workdir / "ae.pt"


def test_precomputed_latents_match_jax_and_refuse_other_weights(tmp_path, monkeypatch):
    """JAX's precompute writes the sidecar from a converted --tiny
    autoencoder; the port's train CLI refuses it (JAX's fingerprint), the
    port's precompute rewrites it with the same moments, keeps it on a
    re-run, and ``latent_edm --cached-latents`` trains from it."""
    jax_make = jdataset.make_synthetic_dataset
    config = configs.LatentSpectrogramConfig(workdir=tmp_path)
    jax_make(config.datapath, n=12, t=4064, seed=1)
    params, ae_pt = _tiny_ae_weights(tmp_path)
    monkeypatch.setattr(jcommon, "load_ae_variables", lambda *a: params)
    jax_precompute.run(argparse.Namespace(config="latent_edm", workdir=str(tmp_path),
                                          dtype="f32", ae_name=None, tiny=True, batch=8,
                                          force=False))
    lat_path = precompute_latents.latents_path(config, "Autoencoder-32x32x4-LogSpectrogram")
    with h5py.File(lat_path) as f:
        want = {k: f[k][:] for k in ("latent_mean", "latent_log_std")}
    argv = ["--workdir", str(tmp_path), "--tiny", "--device", "cpu", "--ae-weights", str(ae_pt)]
    train = ["latent_edm", *argv, "-b", "4", "--max-steps", "2", "--cached-latents"]
    with pytest.raises(SystemExit, match="computed from different AE weights"):
        train_cli.main(train)
    precompute_latents.main([*argv, "-b", "5"])
    with h5py.File(lat_path) as f:
        assert f.attrs["n_rows_written"] == 12 and f.attrs["dtype"] == "f32"
        for k, v in want.items():
            np.testing.assert_allclose(f[k][:], v, rtol=RTOL, atol=ATOL, err_msg=k)
    mtime = lat_path.stat().st_mtime_ns
    precompute_latents.main(argv)  # up to date: kept
    assert lat_path.stat().st_mtime_ns == mtime
    state = train_cli.main(train)
    assert state.step == 2


def _metrics(workdir, run):
    return [json.loads(line) for line in (workdir / "outputs" / run / "metrics.jsonl").open()]


def test_train_cli_chain(tmp_path):
    """The whole chain on one synthetic workdir: the autoencoder recipe,
    ``latent_edm`` with that run's autoencoder (no --ae-weights), its
    precomputed moments and ``--cached-latents``, and the classifier recipe
    with its validation's macro metrics; the evaluate CLI's loader reads the
    classifier's run.  A latent run whose autoencoder has other widths is
    refused by the weights' shapes."""
    common = ["--workdir", str(tmp_path), "--tiny", "--device", "cpu", "-b", "4",
              "--synthetic", "24"]
    ae_state = train_cli.main(["autoencoder", *common, "--max-steps", "2"])
    rows = _metrics(tmp_path, "Autoencoder-32x32x4-LogSpectrogram")
    assert {"training/reconstruction_loss", "training/kl_divergence",
            "training/loss"} <= set(rows[0])
    assert any("validation/reconstruction_loss" in r for r in rows)
    assert ae_state.optimizer.param_groups[0]["weight_decay"] == 1e-4

    edm_state = train_cli.main(["latent_edm", *common, "--max-steps", "1"])
    precompute_latents.main(["--workdir", str(tmp_path), "--tiny", "--device", "cpu"])
    cached = train_cli.main(["latent_edm", *common, "--max-steps", "2", "--cached-latents"])
    assert edm_state.step == 1 and cached.step == 2
    with h5py.File(tmp_path / "data" / "latents-Autoencoder-32x32x4-LogSpectrogram.h5") as f:
        assert f.attrs["ae_fingerprint"] == precompute_latents.ae_fingerprint(
            ae_state.ema.state_dict())

    clf_state = train_cli.main(["classifier", *common, "--max-steps", "3"])
    rows = _metrics(tmp_path, "Classifier-LogSpectrogram")
    val = [r for r in rows if "validation/loss" in r][-1]
    for k in ("accuracy", "macro_accuracy", "macro_precision", "macro_recall", "macro_f1"):
        assert np.isfinite(val[f"validation/{k}"]), k
    assert "validation/tp_counts" not in val
    clf = evaluate_cli.load_classifier_run(tmp_path, "Classifier-LogSpectrogram",
                                           dtype=torch.float32, device="cpu")
    assert clf.encoder.in_conv.out_channels == 16  # the stored --tiny widths
    for name, t in clf.state_dict().items():
        torch.testing.assert_close(t, clf_state.ema.state_dict()[name], msg=name)
    assert evaluate_cli.load_classifier_run(tmp_path, "no-such-run", device="cpu") is None

    with pytest.raises(RuntimeError, match="size mismatch"):  # the full-width AE
        train_cli.main(["latent_edm", *[a for a in common if a != "--tiny"], "--max-steps", "1",
                        "--no-resume"])
