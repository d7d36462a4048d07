"""The port's 1D recipes against the JAX package on the CPU: the moving-average
envelope (host and device), the 1D attention block at 508 and 127 tokens, the
1D UNet and autoencoder, one f32 train step of ``1d_edm``, ``1d_autoencoder``
and ``1d_latent_edm``, Heun and ``dpmpp_2m`` sampling of ``1d_edm`` and
``1d_latent_edm``, and the CLIs from training to evaluation.

Weights go from flax ``init`` shapes, drawn from a numpy seed, through the
port's weight bridge; every random draw of a step is made on the JAX side as
its step makes it and injected.  The JAX models take their Pallas routes
(``use_pallas*=True``) in interpret mode, at short lengths.  Tolerance: f32
rtol 1e-4 / atol 1e-5; a train step's loss to 1e-5 relative and every
gradient to 1e-3 of its peak; sampling with f64 accumulators to rtol 1e-4 /
atol 1e-5.
"""

import base64
import copy

import h5py
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_models import first, load, random_params
from test_torch_port_serve import _request, serving_on_loopback
from test_torch_port_train import jax_step_draws
from tqdne_tpu.data import representation as jrep
from tqdne_tpu.diffusion import edm as jedm
from tqdne_tpu.diffusion import sampler as jsampler
from tqdne_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.nn.attention import AttentionBlock as JaxAttentionBlock
from tqdne_tpu.ops.representation import envelope_representation as jax_envelope
from tqdne_tpu.train import state as jstate
from tqdne_tpu.train import steps as jsteps
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli import evaluate as evaluate_cli
from tqdne_tpu_torch.cli import generate_waveforms, precompute_latents
from tqdne_tpu_torch.cli import serve as serve_cli
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.data.representation import MovingAverageEnvelope, moving_average_same
from tqdne_tpu_torch.diffusion import edm, sampler
from tqdne_tpu_torch.eval.report import evaluation_report
from tqdne_tpu_torch.models.autoencoder import AutoencoderKL
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn.attention import AttentionBlock
from tqdne_tpu_torch.ops.representation import device_representation_fn, envelope_representation
from tqdne_tpu_torch.train.steps import autoencoder_losses, edm_step_loss
from tqdne_tpu_torch.utils import convert, fold_seed, randomize_

RTOL, ATOL = 1e-4, 1e-5
T = 1016  # the autoencoder's signal: the latent UNet's 254 samples attend at 127 tokens
T_SIG = 254  # the 1d_edm UNet's signal, also at 127 tokens (the block test takes 508)
UNET_1D = dict(model_channels=16, num_res_blocks=1, attention_resolutions=(2,),
               channel_mult=(1, 2), num_heads=2, conv_kernel_size=5, dims=1, cond_features=5)
AE_1D = dict(model_channels=8, channel_mult=(1, 2, 4), num_res_blocks=1,
             attention_resolutions=(), dims=1, conv_kernel_size=5)
ENC_1D = AE_1D | {"in_channels": 6, "out_channels": 8}  # (T, 6) -> (T / 4, 4)
DEC_1D = AE_1D | {"in_channels": 4, "out_channels": 6}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, and torch's default thread pool then oversubscribes them (the
    CLI chain ran twentyfold slower that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def waveforms(rng, n=2, t=4064, quiet=False):
    """(n, 3, t) float32 waveforms: a noisy burst, or with ``quiet`` one at
    1e-7 that starts after a run of exact zeros."""
    x = rng.standard_normal((n, 3, t)) * np.exp(-((np.arange(t) - t / 3) / (t / 8)) ** 2)
    if quiet:
        x = x * 1e-7
        x[..., : t // 4] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("quiet", [False, True], ids=["burst", "quiet"])
def test_envelope_matches_jax_on_the_host(rng, quiet):
    """The host forward in float64 against the JAX host path (the fastops
    extension's float64 running sum, or its numpy fallback), where a quiet
    waveform divides by an envelope of about 1e-7 + 1e-6: f32 rounding of
    the same f64 values, rtol 1e-6.  The inverse (float32) agrees with the
    JAX inverse to rtol 1e-4.  Neither is exact where the envelope is near
    its 1e-6 floors: it restores x (env + 2e-6) / (env + 1e-6)."""
    x = waveforms(rng, quiet=quiet)
    np.testing.assert_allclose(moving_average_same(_t(x), 128).numpy(),
                               jrep.moving_average_same(x, 128), rtol=1e-12, atol=1e-18)
    want = jrep.MovingAverageEnvelope().get_representation(x)
    got = MovingAverageEnvelope().get_representation(_t(x))
    assert got.shape == want.shape == (2, 6, 4064) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    back = MovingAverageEnvelope().invert_representation(got).numpy()
    np.testing.assert_allclose(back, jrep.MovingAverageEnvelope().invert_representation(want),
                               rtol=RTOL, atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("quiet", [False, True], ids=["burst", "quiet"])
def test_envelope_matches_jax_on_the_device_path(rng, quiet):
    """``envelope_representation`` (channels last, float64 running sums on
    the waveforms' device) against the JAX host path to rtol 1e-6, quiet
    waveforms included; and against the JAX device transform, which
    differences a float32 running sum, at that transform's own bound against
    the host path (rtol 1e-3 / atol 1e-3, ``tests/test_representation.py``)
    where the envelope stays above its floor: on the quiet waveform the JAX
    transform's sum cancels (see ROADMAP.md section 3)."""
    x = waveforms(rng, quiet=quiet)
    x_cl = np.moveaxis(x, 1, -1).copy()
    want = np.moveaxis(jrep.MovingAverageEnvelope().get_representation(x), 1, -1)
    got = envelope_representation(_t(x_cl))
    assert got.shape == want.shape == (2, 4064, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    torch.testing.assert_close(device_representation_fn(MovingAverageEnvelope())(_t(x_cl)), got)
    if not quiet:
        floor = x_cl + 1e-2 * rng.standard_normal(x_cl.shape).astype(np.float32)
        np.testing.assert_allclose(envelope_representation(_t(floor)).numpy(),
                                   np.asarray(jax_envelope(jnp.asarray(floor))),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("length,channels,heads", [(508, 256, 4), (127, 256, 4)])
def test_1d_attention_block_and_its_gradients_match_jax(rng, length, channels, heads):
    """The 1D UNet's attention at its 508 tokens and the latent UNet's 127,
    D = 64, against the JAX block on its Pallas flash route (forward, dQ and
    dK/dV kernels in interpret mode): output and every gradient."""
    x = rng.standard_normal((2, length, channels)).astype(np.float32)
    jm = JaxAttentionBlock(channels, num_heads=heads, dims=1, use_pallas=True)
    params = random_params(jm, jnp.asarray(x), std=0.05)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply(p, xx) * cot)

    want, (want_gp, want_gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    port = load(AttentionBlock(channels, heads, dims=1), params)
    xt = first(x).requires_grad_()
    out = port(xt)
    got = (out.movedim(1, -1) * _t(cot)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    assert_grads_close(port, want_gp)
    np.testing.assert_allclose(xt.grad.movedim(1, -1).numpy(), np.asarray(want_gx),
                               rtol=0, atol=1e-3 * np.abs(want_gx).max())


def assert_grads_close(module, want_tree):
    """Every gradient of ``module`` within 1e-3 of the peak of JAX's (plus
    1e-6 of the largest peak, for gradients that are zero up to rounding);
    the frozen Fourier W has none on either side."""
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, want_tree))
    largest = max(w.abs().max().item() for w in want.values())
    for name, p in module.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and not want[name].any(), name
            continue
        peak = want[name].abs().max().item()
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 1e-3 * peak + 1e-6 * largest, (name, err, peak, largest)


def unet_pair(channels, length, seed):
    """A 2-level 1D UNet over (length, channels), both sides, same weights."""
    cfg = UNET_1D | {"in_channels": channels, "out_channels": channels}
    jm = JaxUNet(**cfg, use_pallas_norm=True, use_pallas_attention=True)
    params = random_params(jm, jnp.zeros((1, length, channels)), jnp.zeros((1,)),
                           jnp.zeros((1, 5)), seed=seed, std=0.05)
    return jm, params, load(UNet(**cfg), params)


def ae_pair(seed=6):
    jm = JaxAutoencoderKL(encoder_config=ENC_1D, decoder_config=DEC_1D)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0),
                                             "sample": jax.random.key(0)},
                                            jnp.zeros((1, T, 6))))
    gen = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(gen.standard_normal(s.shape).astype(np.float32) * 0.1), shapes)
    return jm, params, load(AutoencoderKL(ENC_1D, DEC_1D), params)


@pytest.fixture(scope="module")
def pairs():
    """The 1d_edm UNet over (T_SIG, 6), the 1D autoencoder over (T, 6), and
    the latent UNet over its (T / 4, 4) latent."""
    return {"signal": unet_pair(6, T_SIG, 11), "ae": ae_pair(),
            "latent": unet_pair(4, T // 4, 12)}


def test_1d_unet_and_autoencoder_match_jax(rng, pairs):
    """The UNet's output, and the autoencoder's moments, encode (JAX's eps
    injected) and decode; the bridge carries every 1D kernel (k, in, out)
    to (out, in, k)."""
    jm, params, port = pairs["signal"]
    assert port.in_conv.weight.shape == (16, 6, 5)
    x = rng.standard_normal((2, T_SIG, 6)).astype(np.float32)
    t = rng.standard_normal(2).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(cond))
    assert got.shape == want.shape == (2, T_SIG, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    x = rng.standard_normal((2, T, 6)).astype(np.float32)

    jae, ae_params, port_ae = pairs["ae"]
    key = jax.random.key(3)
    want_z = jae.apply(ae_params, jnp.asarray(x), method="encode", rngs={"sample": key})
    k_eps = jae.apply(ae_params, jnp.asarray(x), method=lambda m, x: m.make_rng("sample"),
                      rngs={"sample": key})
    want_moments = jae.apply(ae_params, jnp.asarray(x), method="moments")
    want_dec = jae.apply(ae_params, want_z, method="decode")
    with torch.no_grad():
        got_z = port_ae.encode(_t(x), eps=_t(jax.random.normal(k_eps, want_z.shape)))
        got_moments = port_ae.moments(_t(x))
        got_dec = port_ae.decode(_t(want_z))
    assert got_z.shape == (2, T // 4, 4) and got_dec.shape == (2, T, 6)
    for g, w in [(got_z, want_z), (got_dec, want_dec), *zip(got_moments, want_moments)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def jax_edm_loss_and_grads(jm, params, batch, key, jae=None, ae_params=None):
    """``jax.value_and_grad`` of the JAX EDM step's loss: its eval step, which
    is the train step's loss with the same key split and no dropout."""
    _, eval_step, _ = jsteps.make_edm_steps(jm, optax.adam(1e-4), autoencoder=jae)

    def loss(p):
        return eval_step(jstate.TrainState(0, p, p, None), batch, key, ae_params)["loss"]

    return jax.jit(jax.value_and_grad(loss))(params)


def edm_draws(key, shape):
    """The sigma normal and the noise of the JAX EDM step without an autoencoder."""
    key_sigma, key_noise = jax.random.split(jax.random.split(key, 4)[2])
    return {"sigma_eps": _t(jax.random.normal(key_sigma, shape[:1])),
            "noise": _t(jax.random.normal(key_noise, shape))}


def check_edm_step(jm, params, port, signal, cond, key, jae=None, ae_params=None,
                   port_ae=None, model_shape=None):
    """One f32 EDM step of ``port`` against JAX: loss to 1e-5 relative, every
    gradient to 1e-3 of its peak."""
    batch = {"signal": jnp.asarray(signal), "cond": jnp.asarray(cond)}
    want_loss, want_grads = jax_edm_loss_and_grads(jm, params, batch, key, jae, ae_params)
    if jae is None:
        draws = edm_draws(key, signal.shape)
    else:
        draws = {k: _t(np.asarray(v)) for k, v in jax_step_draws(
            jae, ae_params, batch["signal"], key, (len(signal), *model_shape)).items()}
    unet = copy.deepcopy(port).train()
    loss = edm_step_loss(unet, {"signal": _t(signal), "cond": _t(cond)}, autoencoder=port_ae,
                         draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert_grads_close(unet, want_grads)


def test_1d_edm_train_step_matches_jax(rng, pairs):
    jm, params, port = pairs["signal"]
    signal = MovingAverageEnvelope().get_representation(_t(waveforms(rng, t=T_SIG)))
    check_edm_step(jm, params, port, signal.movedim(1, -1).numpy(),
                   rng.standard_normal((2, 5)).astype(np.float32), jax.random.key(31))


def test_1d_latent_edm_train_step_matches_jax(rng, pairs):
    """The frozen 1D encoder inside the step (JAX's eps injected), then the
    latent UNet's loss and gradients."""
    jm, params, port = pairs["latent"]
    jae, ae_params, port_ae = pairs["ae"]
    signal = rng.uniform(-1, 1, (2, T, 6)).astype(np.float32)
    check_edm_step(jm, params, port, signal, rng.standard_normal((2, 5)).astype(np.float32),
                   jax.random.key(32), jae, ae_params, port_ae, (T // 4, 4))


def test_1d_autoencoder_train_step_matches_jax(rng, pairs):
    """The 1d_autoencoder recipe's loss (reconstruction MSE + 1e-6 KL) and
    every gradient against the JAX step's, JAX's eps injected."""
    jae, params, port = pairs["ae"]
    signal = rng.uniform(-1, 1, (2, T, 6)).astype(np.float32)
    key = jax.random.key(33)
    _, eval_step = jsteps.make_autoencoder_steps(jae, optax.adam(1e-4), kl_weight=1e-6)

    def loss(p):
        metrics = eval_step(jstate.TrainState(0, p, p, None), {"signal": jnp.asarray(signal)},
                            key)
        return metrics["loss"], metrics

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    eps = jax.random.normal(jax.random.split(key, 3)[0], (2, T // 4, 4))
    ae = copy.deepcopy(port).train()
    ae.apply(lambda m: m.eval() if isinstance(m, torch.nn.Dropout) else None)
    got = autoencoder_losses(ae, {"signal": _t(signal)}, kl_weight=1e-6,
                             draws={"ae_eps": _t(eps)})
    got["loss"].backward()
    for k in ("reconstruction_loss", "kl_divergence"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    assert_grads_close(ae, want_grads)


def sample_both(jm, params, port, eps, cond, solver, decode=None):
    """3 steps of ``solver`` (5 Heun or 3 DPM++ evaluations) with f32
    evaluations and f64 accumulators on both sides from the same injected
    noise; ``decode``: (JAX, port) decoders applied to the f32 result."""
    sigmas = np.asarray(jedm.sampling_sigmas(jedm.EDMConfig(), 3), np.float64)
    eps = eps * sigmas[0]

    def port_denoise(x, sigma):
        return edm.precondition(edm.EDMConfig(), port, x, sigma, cond=_t(cond))

    port_solver = sampler.heun_deterministic if solver == "heun" else sampler.dpmpp_2m
    with torch.no_grad():
        got = port_solver(port_denoise, _t(eps), _t(sigmas))
        if decode is not None:
            got = decode[1](got.float()).double()
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
    if decode is not None:
        want = np.asarray(decode[0](jnp.asarray(want, jnp.float32)))
    return got.numpy(), want


@pytest.mark.parametrize("solver", ["heun", "dpmpp_2m"])
@pytest.mark.parametrize("recipe", ["1d_edm", "1d_latent_edm"])
def test_1d_sampling_matches_jax(rng, pairs, recipe, solver):
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    if recipe == "1d_edm":
        jm, params, port = pairs["signal"]
        got, want = sample_both(jm, params, port, rng.standard_normal((2, T_SIG, 6)), cond,
                                solver)
    else:
        jm, params, port = pairs["latent"]
        jae, ae_params, port_ae = pairs["ae"]
        decode = (lambda z: jae.apply(ae_params, z, method="decode"), port_ae.decode)
        got, want = sample_both(jm, params, port, rng.standard_normal((2, T // 4, 4)), cond,
                                solver, decode)
    assert got.shape == want.shape == (2, T if recipe == "1d_latent_edm" else T_SIG, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_build_inference_refuses_what_the_recipes_do_not_have():
    for key, match in (("1d_autoencoder", "no sampler"), ("classifier", "no sampler")):
        with pytest.raises(SystemExit, match=match):
            common.build_inference(key, device="cpu", tiny=True)
    # the few-eval recipes sample (``consistency`` over the 1D envelope); an EDM
    # recipe takes no few-eval solver
    bundle = common.build_inference("consistency", dtype=torch.float32, device="cpu", tiny=True)
    assert (bundle.kind, bundle.model_shape) == ("consistency", (4064, 6))
    with pytest.raises(SystemExit, match="unknown solver 'consistency' for an EDM recipe"):
        common.build_inference("1d_edm", solver="consistency", device="cpu", tiny=True)
    with pytest.raises(SystemExit, match="no Griffin-Lim"):
        common.build_inference("1d_edm", gl_iters=4, device="cpu", tiny=True)
    assert common.signal_shape(configs.MovingAverageEnvelopeConfig()) == (4064, 6)


def test_1d_entry_points_ask_for_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.build_inference("1d_edm", tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["1d_edm", "--workdir", str(tmp_path), "--tiny"])


def test_1d_cli_chain(tmp_path, capsys):
    """``1d_autoencoder``, its precomputed moments (``--config
    1d_latent_edm``), ``1d_latent_edm --cached-latents`` and ``1d_edm`` with
    the envelope on the device, one step each on a synthetic workdir; then
    generate from both samplers' runs, serve both (``1d_edm``'s seeded rows
    bit-identical, 6 signal channels, no Griffin-Lim) and evaluate it with a
    classifier, whose datasets the 1D signal skips while the waveform
    metrics are written."""
    wd = str(tmp_path)
    run = ["--workdir", wd, "--tiny", "--device", "cpu", "-b", "4", "--synthetic", "24",
           "--max-steps", "1", "--dtype", "f32"]
    ae_state = train_cli.main(["1d_autoencoder", *run])
    assert ae_state.optimizer.param_groups[0]["weight_decay"] == 1e-4
    precompute_latents.main(["--workdir", wd, "--config", "1d_latent_edm", "--tiny", "--device",
                             "cpu"])
    with h5py.File(tmp_path / "data" / "latents-Autoencoder-1024x16-MovingAvg.h5") as f:
        assert f["latent_mean"].shape == (24, 1016, 16)
    assert train_cli.main(["1d_latent_edm", *run, "--cached-latents"]).step == 1
    assert train_cli.main(["1d_edm", *run, "--device-representation"]).step == 1
    with pytest.raises(SystemExit, match="needs a latent"):
        train_cli.main(["1d_edm", *run, "--cached-latents"])

    flags = ["--hypocentral_distance", "50", "--magnitude", "5.5", "--vs30", "400",
             "--hypocentre_depth", "20", "--azimuthal_gap", "100", "--num_samples", "2",
             "--batch_size", "2", "--num_steps", "2", "--tiny", "--dtype", "f32", "--device",
             "cpu", "--workdir", wd]
    for recipe in ("1d_edm", "1d_latent_edm"):
        out = tmp_path / f"{recipe}.h5"
        generate_waveforms.main(["--config", recipe, "--outfile", str(out), *flags])
        with h5py.File(out) as f:
            wave = f["waveforms"][:]
        # an untrained model's log envelope can overflow exp() in the inversion
        assert wave.shape == (2, 3, 4064) and np.isfinite(wave).mean() > 0.5, recipe

    args = serve_cli.parse_args(["--config", "1d_edm", "--workdir", wd, "--tiny", "--device",
                                 "cpu", "--num-steps", "2", "--dtype", "f32", "--batch-size",
                                 "2", "--port", "0", "--max-delay-ms", "1"])
    server, batcher = serve_cli.build_server(args)
    rows = [[50, 5.5, 400, 20, 100]]
    try:
        with serving_on_loopback(server) as base:
            _, info = _request(base + "/info")
            replies = [_request(base + "/generate", {"conditions": rows, "seed": 7,
                                                     "format": "b64"}) for _ in range(2)]
    finally:
        batcher.shutdown()
    assert info["config"] == "1d_edm" and info["channels"] == 6 and info["t"] == 4064
    waves = [np.frombuffer(base64.b64decode(body["waveforms_b64"]), "<f4") for _, body in replies]
    assert all(status == 200 and body["shape"] == [1, 3, 4064] for status, body in replies)
    assert np.array_equal(waves[0], waves[1], equal_nan=True)
    bundle = common.build_inference("1d_edm", workdir=wd, dtype=torch.float32, num_steps=2,
                                    device="cpu", tiny=True)
    want = bundle.sampler(2)(fold_seed(7, 0), (np.array(rows) - generate_waveforms.
                                               SUMMARY_STATISTICS[:, 0]) /
                             generate_waveforms.SUMMARY_STATISTICS[:, 1])[:1].numpy()
    np.testing.assert_allclose(waves[0].reshape(want.shape), want, rtol=1e-5, atol=1e-5)
    args = serve_cli.parse_args(["--config", "1d_latent_edm", "--workdir", wd, "--tiny",
                                 "--device", "cpu", "--num-steps", "2", "--dtype", "f32",
                                 "--batch-size", "1", "--port", "0", "--max-delay-ms", "1"])
    server, batcher = serve_cli.build_server(args)
    try:
        with serving_on_loopback(server) as base:
            status, body = _request(base + "/generate", {"conditions": rows, "seed": 7})
    finally:
        batcher.shutdown()
    assert status == 200 and np.asarray(body["waveforms"]).shape == (1, 3, 4064)
    with pytest.raises(SystemExit, match="no Griffin-Lim"):
        serve_cli.build_server(serve_cli.parse_args(["--config", "1d_edm", "--gl-iters", "4",
                                                     "--device", "cpu", "--tiny"]))

    clf_config = configs.SpectrogramClassificationConfig()
    clf = randomize_(Classifier(configs.get_classifier_encoder_config(clf_config),
                                clf_config.num_classes), 0)
    torch.save(clf.state_dict(), tmp_path / "clf.pt")
    evaluate_cli.main(["--workdir", wd, "--config", "1d_edm", "-b", "2", "--num_steps", "2",
                       "--limit-batches", "1", "--tiny", "--dtype", "f32", "--device", "cpu",
                       "--classifier-weights", str(tmp_path / "clf.pt")])
    assert "skipping classifier datasets" in capsys.readouterr().out
    path = tmp_path / "evaluation" / "EDM-MovingAvg-split_test-rank_0.h5"
    with h5py.File(path) as f:
        assert f["target_signal"].shape == f["predicted_signal"].shape == (2, 6, 4064)
        assert f["predicted_waveform"].shape == (2, 3, 4064)
        assert "target_classifier_embedding" not in f and "magnitude" in f
    report = evaluation_report([path])
    assert report["fid"] is None and len(report["asd_frechet_per_channel"]) == 3
    assert len(report["mse_per_channel"]) == 3
