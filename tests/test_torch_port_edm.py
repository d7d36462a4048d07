"""The port's pixel-space ``edm`` recipe against the JAX package on the CPU:
the attention block at the recipe's 256 tokens and D = 128, one f32 train
step over the spectrogram (no autoencoder), Heun and ``dpmpp_2m`` sampling
without a decode, and the CLIs from training to evaluation.

As in ``tests/test_torch_port_1d.py``: weights from a numpy seed through the
weight bridge, the step's draws made on the JAX side and injected, the JAX
models on their Pallas routes in interpret mode.  Tolerance: f32 rtol 1e-4 /
atol 1e-5; the train step's loss to 1e-5 relative and every gradient to 1e-3
of its peak; sampling with f64 accumulators to rtol 1e-4 / atol 1e-5.
"""

import json

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_1d import one_torch_thread  # noqa: F401  (its autouse fixture)
from test_torch_port_1d import assert_grads_close, check_edm_step, sample_both
from test_torch_port_models import first, load, random_params
from test_torch_port_serve import _request, serving_on_loopback
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.nn.attention import AttentionBlock as JaxAttentionBlock
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli import evaluate as evaluate_cli
from tqdne_tpu_torch.cli import generate_waveforms
from tqdne_tpu_torch.cli import serve as serve_cli
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn.attention import AttentionBlock

RTOL, ATOL = 1e-4, 1e-5
# the edm UNet's topology over a 16 x 16 x 3 spectrogram: attention at ds 2
UNET_2D = dict(in_channels=3, out_channels=3, model_channels=16, num_res_blocks=1,
               attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, conv_kernel_size=3,
               dims=2, cond_features=5)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_attention_block_at_the_edm_shape_and_its_gradients_match_jax(rng):
    """The 2D UNet's attention at 16 x 16 = 256 tokens with 512 channels in
    4 heads (D = 128), against the JAX block on its Pallas flash route in
    interpret mode: output and every gradient."""
    x = rng.standard_normal((1, 16, 16, 512)).astype(np.float32)
    jm = JaxAttentionBlock(512, num_heads=4, use_pallas=True)
    params = random_params(jm, jnp.asarray(x), std=0.03)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply(p, xx) * cot)

    want, (want_gp, want_gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    port = load(AttentionBlock(512, 4), params)
    xt = first(x).requires_grad_()
    got = (port(xt).movedim(1, -1) * _t(cot)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    assert_grads_close(port, want_gp)
    np.testing.assert_allclose(xt.grad.movedim(1, -1).numpy(), np.asarray(want_gx),
                               rtol=0, atol=1e-3 * np.abs(want_gx).max())


@pytest.fixture(scope="module")
def unet_pair():
    jm = JaxUNet(**UNET_2D, use_pallas_norm=True, use_pallas_attention=True)
    params = random_params(jm, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)), jnp.zeros((1, 5)),
                           seed=13, std=0.05)
    return jm, params, load(UNet(**UNET_2D), params)


def test_edm_train_step_matches_jax(rng, unet_pair):
    """The pixel-space EDM step: the loss over the spectrogram itself (no
    encoder) and every gradient."""
    signal = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    check_edm_step(*unet_pair, signal, rng.standard_normal((2, 5)).astype(np.float32),
                   jax.random.key(41))


@pytest.mark.parametrize("solver", ["heun", "dpmpp_2m"])
def test_edm_sampling_matches_jax(rng, unet_pair, solver):
    got, want = sample_both(*unet_pair, rng.standard_normal((2, 16, 16, 3)),
                            rng.standard_normal((2, 5)).astype(np.float32), solver)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_edm_cli_chain(tmp_path):
    """``edm`` and the classifier recipe one step each on a synthetic
    workdir; the bundle rebuilt from the run's stored widths; generate,
    serve and evaluate ``--config edm`` from the runs (the classifier's
    datasets written: the signal is its 128 x 128 x 3 spectrogram)."""
    wd = str(tmp_path)
    run = ["--workdir", wd, "--tiny", "--device", "cpu", "-b", "2", "--synthetic", "24",
           "--max-steps", "1", "--dtype", "f32"]
    state = train_cli.main(["edm", *run])
    hparams = json.loads((tmp_path / "outputs" / "EDM-128x128-LogSpectrogram" / "checkpoints" /
                          "hparams.json").read_text())
    assert hparams["unet"]["in_channels"] == 3 and hparams["latent"] is False
    train_cli.main(["classifier", *run])
    bundle = common.build_inference("edm", workdir=wd, dtype=torch.float32, num_steps=2,
                                    gl_iters=2, device="cpu")  # widths from hparams.json
    assert bundle.autoencoder is None and bundle.model_shape == bundle.sig_shape == (128, 128, 3)
    for name, t in bundle.unet.state_dict().items():
        torch.testing.assert_close(t, state.ema.state_dict()[name], msg=name)

    out = tmp_path / "edm.h5"
    generate_waveforms.main(["--config", "edm", "--workdir", wd, "--outfile", str(out),
                             "--hypocentral_distance", "50", "--magnitude", "5.5", "--vs30",
                             "400", "--hypocentre_depth", "20", "--azimuthal_gap", "100",
                             "--num_samples", "2", "--batch_size", "2", "--num_steps", "2",
                             "--gl-iters", "2", "--tiny", "--dtype", "f32", "--device", "cpu"])
    with h5py.File(out) as f:
        wave = f["waveforms"][:]
    assert wave.shape == (2, 3, 4064) and np.isfinite(wave).all()

    args = serve_cli.parse_args(["--config", "edm", "--workdir", wd, "--tiny", "--device",
                                 "cpu", "--num-steps", "2", "--gl-iters", "2", "--dtype", "f32",
                                 "--batch-size", "2", "--port", "0", "--max-delay-ms", "1"])
    server, batcher = serve_cli.build_server(args)
    try:
        with serving_on_loopback(server) as base:
            _, info = _request(base + "/info")
            status, body = _request(base + "/generate",
                                    {"conditions": [[50, 5.5, 400, 20, 100]], "seed": 3})
    finally:
        batcher.shutdown()
    assert info["config"] == "edm" and info["channels"] == 3
    assert status == 200 and np.asarray(body["waveforms"]).shape == (1, 3, 4064)

    evaluate_cli.main(["--workdir", wd, "--config", "edm", "-b", "2", "--num_steps", "2",
                       "--limit-batches", "1", "--tiny", "--dtype", "f32", "--device", "cpu"])
    with h5py.File(tmp_path / "evaluation" / "EDM-128x128-LogSpectrogram-split_test-rank_0.h5"
                   ) as f:
        assert f["target_signal"].shape == (2, 3, 128, 128)
        assert f["predicted_classifier_pred"].shape == (2, configs.SpectrogramClassificationConfig()
                                                        .num_classes)
        assert np.isfinite(f["predicted_classifier_embedding"][:]).all()
