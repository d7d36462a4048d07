"""The port's sampling slice against the JAX package on the CPU: EDM
scalings, the samplers, the log-spectrogram representation, and
conditioning -> waveform through ``build_inference``.

Noise and Griffin-Lim's initial phase are drawn once (numpy, or
``jax.random.uniform`` exactly as the JAX function draws it) and injected
into both sides.  The JAX UNet takes its Pallas route in interpret mode.
"""

import math

import h5py
import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from test_torch_port_models import random_params, small_unet_pair
from tqdne_tpu import configs as jconfigs
from tqdne_tpu.cli.common import build_autoencoder, build_unet
from tqdne_tpu.data.representation import LogSpectrogram as JaxLogSpectrogram
from tqdne_tpu.diffusion import edm as jedm
from tqdne_tpu.diffusion import sampler as jsampler
from tqdne_tpu_torch.cli import generate_waveforms
from tqdne_tpu_torch.cli.common import build_inference
from tqdne_tpu_torch.data.representation import LogSpectrogram
from tqdne_tpu_torch.diffusion import edm, sampler
from tqdne_tpu_torch.utils import convert

RTOL, ATOL = 1e-4, 1e-5


def test_sampling_sigmas_and_precondition_match_jax(rng):
    cfg = edm.EDMConfig()
    for n in (2, 10, 25):
        np.testing.assert_allclose(edm.sampling_sigmas(cfg, n).numpy(),
                                   np.asarray(jedm.sampling_sigmas(jedm.EDMConfig(), n)),
                                   rtol=RTOL, atol=ATOL)
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    sigma = np.array([0.01, 1.0, 60.0], np.float32)
    cond = rng.standard_normal((3, 5)).astype(np.float32)

    def net(lib):  # a toy network using all three inputs
        def apply(x, c_noise, c):
            return lib.tanh(x) * c_noise[:, None, None, None] + c.sum(-1)[:, None, None, None]
        return apply

    want = jedm.precondition(jedm.EDMConfig(), net(jnp), jnp.asarray(x), jnp.asarray(sigma),
                             cond=jnp.asarray(cond))
    got = edm.precondition(cfg, net(torch), torch.from_numpy(x), torch.from_numpy(sigma),
                           cond=torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def unet_pair():
    return small_unet_pair(seed=2)


@pytest.mark.parametrize("solver", ["heun", "dpmpp_2m"])
def test_samplers_match_jax_with_f64_accumulators(rng, unet_pair, solver):
    """4 steps (7 Heun / 4 DPM++ evaluations) of the small UNet with f32
    evaluations and f64 accumulators on both sides, the same injected noise."""
    jm, params, port = unet_pair
    num_steps = 4
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    sigmas = np.asarray(jedm.sampling_sigmas(jedm.EDMConfig(), num_steps), np.float64)
    eps = rng.standard_normal((2, 8, 8, 8)) * sigmas[0]

    def port_denoise(x, sigma):
        return edm.precondition(edm.EDMConfig(), port, x, sigma, cond=torch.from_numpy(cond))

    port_solver = sampler.heun_deterministic if solver == "heun" else sampler.dpmpp_2m
    with torch.no_grad():
        got = port_solver(port_denoise, torch.from_numpy(eps), torch.from_numpy(sigmas)).numpy()

    jax_solver = jsampler.heun_deterministic if solver == "heun" else jsampler.dpmpp_2m
    jax.config.update("jax_enable_x64", True)
    try:
        def jax_denoise(x, sigma):
            return jedm.precondition(jedm.EDMConfig(), lambda *a: jm.apply(params, *a), x, sigma,
                                     cond=jnp.asarray(cond))

        want = np.asarray(jax.jit(lambda e, s: jax_solver(jax_denoise, e, s))(
            jnp.asarray(eps, jnp.float64), jnp.asarray(sigmas, jnp.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_heun_stochastic_without_churn_is_heun(rng, unet_pair):
    _, _, port = unet_pair
    cond = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    sigmas = edm.sampling_sigmas(edm.EDMConfig(), 3)
    eps = torch.from_numpy(rng.standard_normal((2, 8, 8, 8)).astype(np.float32)) * sigmas[0]

    def denoise(x, sigma):
        return edm.precondition(edm.EDMConfig(), port, x, sigma, cond=cond)

    with torch.no_grad():
        want = sampler.heun_deterministic(denoise, eps, sigmas)
        got = sampler.heun_stochastic(denoise, eps, sigmas, edm.EDMConfig(S_churn=0.0),
                                      generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_log_spectrogram_matches_jax(rng):
    """Forward against the numpy host path; inverse against the JAX
    Griffin-Lim with its key's phase injected.  Magnitudes come from exp of
    a [-21, 3] log range, so the waveform bound is relative to its peak."""
    wave = (rng.standard_normal((2, 3, 4064)) * np.linspace(0, 3, 4064)).astype(np.float32)
    rep = JaxLogSpectrogram(hop_size=32, backend="jax", n_iter=4)
    port = LogSpectrogram(hop_size=32, n_iter=4)
    fwd = port.get_representation(torch.from_numpy(wave))
    np.testing.assert_allclose(fwd.numpy(), rep.get_representation(wave), rtol=RTOL, atol=1e-4)

    signal = rng.uniform(-1, 1, (2, 3, 128, 128)).astype(np.float32)
    want = rep.invert_representation(signal)
    phase = 2 * math.pi * np.asarray(jax.random.uniform(jax.random.key(0), (2, 3, 129, 128)))
    got = port.invert_representation(torch.from_numpy(signal),
                                     init_phase=torch.from_numpy(phase)).numpy()
    assert got.shape == want.shape == (2, 3, 4064)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny_flagship(tmp_path_factory):
    """32-channel flagship UNet and autoencoder with random weights, written
    as flax msgpack artifacts and converted with the port's converter CLI."""
    tmp = tmp_path_factory.mktemp("tiny_flagship")
    config = jconfigs.LatentSpectrogramConfig(workdir=str(tmp))
    unet, _ = build_unet(config, 2, 8, 8, cond_features=5, model_channels=32,
                         use_pallas_norm=True, use_pallas_attention=True)
    ae, _, _ = build_autoencoder(config, 2, model_channels=32)
    unet_params = random_params(unet, jnp.zeros((1, 32, 32, 8)), jnp.zeros((1,)),
                                jnp.zeros((1, 5)), seed=3, std=0.05)
    shapes = jax.eval_shape(lambda: ae.init({"params": jax.random.key(0),
                                             "sample": jax.random.key(0)},
                                            jnp.zeros((1, 128, 128, 3))))
    gen = np.random.default_rng(4)
    ae_params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(gen.standard_normal(s.shape).astype(np.float32) * 0.02), shapes)
    paths = {}
    for name, params in (("unet", unet_params), ("ae", ae_params)):
        src = tmp / f"{name}.msgpack"
        src.write_bytes(serialization.to_bytes(params))
        paths[name] = tmp / f"{name}.pt"
        convert.main([str(src), str(paths[name])])
    return config, unet, unet_params, ae, ae_params, paths


def test_generation_end_to_end_matches_jax(rng, tiny_flagship):
    """Conditioning -> waveform: 2 Heun steps (3 evaluations), decode,
    de-normalise and 4 Griffin-Lim iterations.  exp() of the decoded log
    spectrogram scales its error by the ~21 nat log range, so the bound is
    1e-4 of the waveform's peak."""
    config, unet, unet_params, ae, ae_params, paths = tiny_flagship
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    noise = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)

    sigmas = jedm.sampling_sigmas(jedm.EDMConfig(), 2)

    @jax.jit
    def jax_signal(noise, cond):
        def denoise(x, sigma):
            return jedm.precondition(jedm.EDMConfig(), lambda *a: unet.apply(unet_params, *a),
                                     x, sigma, cond=cond)

        latent = jsampler.heun_deterministic(denoise, noise * sigmas[0], sigmas)
        return ae.apply(ae_params, latent, method="decode")

    config.griffin_lim_iters = 4
    signal = np.moveaxis(np.asarray(jax_signal(jnp.asarray(noise), jnp.asarray(cond))), -1, 1)
    want = config.make_representation().invert_representation(signal)

    bundle = build_inference(unet_weights=paths["unet"], ae_weights=paths["ae"],
                             dtype=torch.float32, num_steps=2, gl_iters=4, device="cpu",
                             tiny=True)
    phase = 2 * math.pi * np.asarray(jax.random.uniform(jax.random.key(0), (2, 3, 129, 128)))
    got = bundle.generate(torch.from_numpy(cond), noise=torch.from_numpy(noise),
                          init_phase=torch.from_numpy(phase)).numpy()
    assert got.shape == want.shape == (2, 3, 4064)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_generate_waveforms_cli_writes_hdf5(tmp_path, tiny_flagship):
    *_, paths = tiny_flagship
    csv = tmp_path / "cond.csv"
    csv.write_text("hypocentral_distance,magnitude,vs30,hypocentre_depth,azimuthal_gap,"
                   "num_samples\n30,5.0,350,12,80,2\n120,6.8,500,35,160,1\n")
    out = tmp_path / "out.h5"
    generate_waveforms.main([
        "--csv", str(csv), "--outfile", str(out), "--unet-weights", str(paths["unet"]),
        "--ae-weights", str(paths["ae"]), "--tiny", "--device", "cpu", "--batch-size", "2",
        "--num-steps", "2", "--solver", "dpmpp_2m", "--gl-iters", "2", "--dtype", "f32",
    ])
    with h5py.File(out) as f:
        wave = f["waveforms"][:]
        np.testing.assert_array_equal(f["magnitude"][:], [5.0, 5.0, 6.8])
    assert wave.shape == (3, 3, 4064) and np.isfinite(wave).all() and np.abs(wave).max() > 0


def test_cuda_entry_point_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_inference(device="cuda", tiny=True)
