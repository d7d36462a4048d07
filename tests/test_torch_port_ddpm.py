"""The port's DDPM against the JAX package on the CPU: the beta schedules,
q(x_t | x_0), the loss for epsilon and x0 prediction with a conditioning
signal before x, the ancestral step, the UNet at DDPM's timesteps (t up to
999), the sampler at T = 20, one f32 ``ddpm`` train step (AdamW at weight
decay 0 under the cosine schedule, EMA 0.999), and the ``ddpm`` CLI chain.

T = 1000 steps of the sampler are too slow here: the sampler's test and the
CLI chain run a ``DDPMConfig`` with fewer timesteps (20, and 4 in the chain,
set on the port's own ``DDPMConfig`` for the chain); the card runs 1000.
Tolerance: f32 rtol 1e-4 / atol 1e-5 for functions; a step's loss to 1e-5
relative, every gradient and every parameter's move to 1e-3 of its peak.
At t near 999 the Fourier embedding's argument reaches about 10^2 rad, where
one f32 ulp of it is 1e-5 rad, so the UNet there is held to 1e-4 of its
output's peak.
"""

import copy
import functools
import json

import h5py
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_consistency import L_1D, check_step, jax_step, matrix_net
from test_torch_port_1d import UNET_1D
from test_torch_port_models import load, random_params
from tqdne_tpu.diffusion import ddpm as jddpm
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.train import state as jstate
from tqdne_tpu_torch.cli import evaluate as evaluate_cli
from tqdne_tpu_torch.cli import generate_waveforms
from tqdne_tpu_torch.cli import serve as serve_cli
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.diffusion import ddpm
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.train.state import TrainState, cosine_annealing, make_optimizer

RTOL, ATOL = 1e-4, 1e-5
T20 = dict(num_train_timesteps=20)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("schedule", ["linear", "squaredcos_cap_v2"])
def test_schedule_and_noising_match_jax(rng, schedule):
    """betas and alphas_cumprod at T = 1000, and q(x_t | x_0) at t from 0 to 999.
    The cosine schedule's 1 - f(i + 1) / f(i) cancels near 1, so its betas are
    held to 4 f32 ulps of 1 (2.4e-7) absolute."""
    cfg, jcfg = ddpm.DDPMConfig(beta_schedule=schedule), jddpm.DDPMConfig(beta_schedule=schedule)
    for name in ("betas", "alphas_cumprod"):
        np.testing.assert_allclose(getattr(ddpm, name)(cfg).numpy(),
                                   np.asarray(getattr(jddpm, name)(jcfg)), rtol=RTOL,
                                   atol=2.4e-7, err_msg=name)
    x0, noise = (rng.standard_normal((4, 6, 2)).astype(np.float32) for _ in range(2))
    t = np.array([0, 10, 500, 999])
    np.testing.assert_allclose(ddpm.add_noise(cfg, _t(x0), _t(noise), _t(t)).numpy(),
                               np.asarray(jddpm.add_noise(jcfg, jnp.asarray(x0),
                                                          jnp.asarray(noise), jnp.asarray(t))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prediction", ["epsilon", "sample"])
def test_loss_and_step_match_jax(rng, prediction):
    """The loss with a conditioning signal concatenated before x (a network
    that sees each channel's place), JAX's t and noise injected; then the
    ancestral step at t = 19, 7 and 0 with x0 clipping and JAX's noise."""
    cfg = ddpm.DDPMConfig(prediction_type=prediction, **T20)
    jcfg = jddpm.DDPMConfig(prediction_type=prediction, **T20)
    x = rng.uniform(-1, 1, (3, 8, 2)).astype(np.float32)
    cs = rng.standard_normal((3, 8, 1)).astype(np.float32)
    cond = rng.standard_normal((3, 5)).astype(np.float32)
    m = rng.standard_normal((3, 2)).astype(np.float32)
    key = jax.random.key(8)
    want = jddpm.ddpm_loss(jcfg, matrix_net(jnp, jnp.asarray(m)), key, jnp.asarray(x),
                           cond_signal=jnp.asarray(cs), cond=jnp.asarray(cond))
    key_t, key_n = jax.random.split(key)
    t = jax.random.randint(key_t, (3,), 0, 20)
    noise = jax.random.normal(key_n, x.shape)
    got = ddpm.ddpm_loss(cfg, matrix_net(torch, _t(m)), _t(x), cond_signal=_t(cs),
                         cond=_t(cond), t=_t(t), noise=_t(noise))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    swapped = ddpm.ddpm_loss(cfg, matrix_net(torch, _t(m)), _t(x), cond_signal=_t(cs),
                             cond=_t(cond), t=_t(t), noise=_t(noise)[..., [1, 0]])
    assert abs(swapped.item() - float(want)) > 1e-3

    out = rng.standard_normal(x.shape).astype(np.float32) * 2
    for step in (19, 7, 0):
        k = jax.random.key(step)
        want = jddpm.ddpm_step(jcfg, jnp.asarray(out), step, jnp.asarray(x), k)
        got = ddpm.ddpm_step(cfg, _t(out), step, _t(x),
                             _t(jax.random.normal(k, x.shape)) if step else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=str(step))


@pytest.fixture(scope="module")
def pair_1d():
    cfg = UNET_1D | {"in_channels": 6, "out_channels": 6}
    jm = JaxUNet(**cfg)
    params = random_params(jm, jnp.zeros((1, L_1D, 6)), jnp.zeros((1,)), jnp.zeros((1, 5)),
                           seed=31, std=0.05)
    return jm, params, load(UNet(**cfg), params)


def test_unet_at_ddpm_timesteps_matches_jax(rng, pair_1d):
    """The UNet at t = 0, 500 and 999: the Fourier embedding's argument
    2 pi t W (W ~ N(0, 0.02^2)) reaches about 10^2 rad, so the output is held
    to 1e-4 of its peak (see the module's docstring)."""
    jm, params, port = pair_1d
    x = rng.standard_normal((3, L_1D, 6)).astype(np.float32)
    t = np.array([0.0, 500.0, 999.0], np.float32)
    cond = rng.standard_normal((3, 5)).astype(np.float32)
    assert np.abs(999 * 2 * np.pi * np.asarray(params["params"]["time_embed"]["W"])).max() > 50
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(cond)))
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_sampler_at_20_steps_matches_jax(rng, pair_1d):
    """``ddpm_sample`` against the JAX ``lax.scan`` sampler at T = 20, its
    initial draw and per-step noise injected."""
    jm, params, port = pair_1d
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    shape, key = (2, L_1D, 6), jax.random.key(19)
    jcfg = jddpm.DDPMConfig(**T20)
    want = jax.jit(lambda k, c: jddpm.ddpm_sample(
        jcfg, lambda x, t, c: jm.apply(params, x, t, c), k, shape, cond=c))(key, jnp.asarray(cond))
    key_init, key_loop = jax.random.split(key)
    keys = jax.random.split(key_loop, 20)
    x = _t(jax.random.normal(key_init, shape))
    step_noise = [_t(jax.random.normal(k, shape)) for k in keys]
    got = ddpm.ddpm_sample(ddpm.DDPMConfig(**T20), port, shape, cond=_t(cond), x=x,
                           step_noise=step_noise, device="cpu")
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(np.asarray(want)).max()))


def test_ddpm_train_step_matches_jax(rng, pair_1d):
    """One f32 ``ddpm`` step at T = 1000 (its t drawn up to 999): the loss
    and every gradient of the JAX ``train_step``, then AdamW at weight decay
    0 (the frozen-W mask) under the cosine schedule and the EMA 0.999."""
    jm, params, port = pair_1d
    signal = rng.uniform(-1, 1, (4, L_1D, 6)).astype(np.float32)
    cond = rng.standard_normal((4, 5)).astype(np.float32)
    key = jax.random.key(62)  # its t reach 937
    j_train, _, _ = jddpm.make_ddpm_steps(jm, optax.sgd(1.0), jddpm.DDPMConfig())
    batch = {"signal": jnp.asarray(signal), "cond": jnp.asarray(cond)}
    tx = jstate.make_optimizer("adamw", jstate.cosine_annealing(1e-4, 100), weight_decay=0.0)
    want_loss, want_grads = jax_step(j_train, params, batch, key)
    _, key_loss = jax.random.split(key)
    key_t, key_n = jax.random.split(key_loss)
    draws = {"t": _t(jax.random.randint(key_t, (4,), 0, 1000)),
             "noise": _t(jax.random.normal(key_n, signal.shape))}
    assert draws["t"].max() > 500

    pbatch = {"signal": _t(signal), "cond": _t(cond)}
    unet = copy.deepcopy(port).train()
    loss = ddpm.ddpm_loss(ddpm.DDPMConfig(), unet, pbatch["signal"], cond=pbatch["cond"],
                          **draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)

    model = copy.deepcopy(port)
    st = TrainState(model, make_optimizer("adamw", model, 1e-4, 0.0), cosine_annealing(1e-4, 100))
    train_step, _ = ddpm.make_ddpm_steps(ddpm.DDPMConfig())
    check_step(lambda: train_step(st, pbatch, draws=draws), st, want_loss, want_grads, unet,
               tx, 0.999, params)


def test_ddpm_cli_chain(tmp_path, monkeypatch):
    """``ddpm`` for a step (AdamW at weight decay 0 under the cosine schedule:
    ``lr`` in the metrics; ``--device-representation`` refused, as JAX refuses
    it, and ``--cached-latents`` refused for a recipe without a latent); then,
    at 2 timesteps set on the port's own ``DDPMConfig`` (1000 are too slow
    here), generate, serve (25 steps asked, DDPM's own count run) and
    evaluate from its run."""
    wd = str(tmp_path)
    run = ["--workdir", wd, "--tiny", "--device", "cpu", "-b", "4", "--synthetic", "12",
           "--dtype", "f32", "--max-steps", "1"]
    with pytest.raises(SystemExit, match="--device-representation is supported for EDM"):
        train_cli.main(["ddpm", *run, "--device-representation"])
    with pytest.raises(SystemExit, match="needs a latent EDM, consistency or distill"):
        train_cli.main(["consistency", *run, "--cached-latents"])
    state = train_cli.main(["ddpm", *run])
    group = state.optimizer.param_groups[0]
    assert isinstance(state.optimizer, torch.optim.AdamW) and group["weight_decay"] == 0.0
    rows = [json.loads(line) for line in
            (tmp_path / "outputs" / "DDPM-MovingAvg" / "metrics.jsonl").open()]
    assert any("lr" in r for r in rows)

    monkeypatch.setattr(ddpm, "DDPMConfig", functools.partial(ddpm.DDPMConfig,
                                                              num_train_timesteps=2))
    out = tmp_path / "p.h5"
    generate_waveforms.main(["--config", "ddpm", "--workdir", wd, "--device", "cpu",
                             "--num_samples", "2", "--hypocentral_distance", "50",
                             "--magnitude", "5", "--vs30", "400", "--hypocentre_depth", "10",
                             "--azimuthal_gap", "100", "--outfile", str(out), "--dtype", "f32"])
    with h5py.File(out) as f:
        assert f["waveforms"].shape == (2, 3, 4064) and np.isfinite(f["waveforms"][:]).all()
    args = serve_cli.parse_args(["--config", "ddpm", "--workdir", wd, "--device", "cpu",
                                 "--dtype", "f32", "--batch-size", "2", "--port", "0"])
    server, batcher = serve_cli.build_server(args)
    try:
        wave = batcher.generate(np.zeros((2, 5), np.float32), seed=2)
        assert wave.shape == (2, 3, 4064) and np.isfinite(wave).all()
    finally:
        server.server_close()
        batcher.shutdown()
    evaluate_cli.main(["--workdir", wd, "--config", "ddpm", "--device", "cpu", "--dtype", "f32",
                       "-b", "4", "--limit-batches", "1"])
    with h5py.File(tmp_path / "evaluation" / "DDPM-MovingAvg-split_test-rank_0.h5") as f:
        assert np.isfinite(f["predicted_waveform"][:]).all()
        assert "predicted_classifier_pred" not in f
