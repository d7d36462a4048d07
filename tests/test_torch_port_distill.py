"""The port's consistency distillation against the JAX package on the CPU: the
EDM-conditioned student network, the teacher's Heun step and the CD loss
with injected draws, one f32 ``latent_distill`` train step (a frozen
teacher, the student, the EMA target: loss, every gradient, the parameters
after RAdam and the EMA), the distilled sampler with decode at 1 and 2
network evals, and the latent CLI chain: ``autoencoder``, the ``latent_edm``
teacher, ``latent_distill`` and ``latent_consistency`` from cached latents,
then generate, serve and evaluate through ``--solver distill|consistency``.

Weights are flax ``init`` shapes drawn from a numpy seed, through the port's
weight bridge; the JAX UNet takes its default route (see
``test_torch_port_consistency.py``).  Tolerance: f32 rtol 1e-4 / atol 1e-5
for functions; a step's loss to 1e-5 relative, every gradient and every
parameter's move to 1e-3 of its peak.
"""

import copy
import json

import h5py
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_consistency import (
    TINY_2D,
    check_step,
    encoder_eps,
    jax_step,
    matrix_net,
    sampler_draws,
)
from test_torch_port_models import load, random_params
from test_torch_port_train import tiny_ae_pair
from tqdne_tpu.diffusion import consistency as jcons
from tqdne_tpu.diffusion import distillation as jdist
from tqdne_tpu.diffusion import edm as jedm
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.cli import evaluate as evaluate_cli
from tqdne_tpu_torch.cli import generate_waveforms, precompute_latents
from tqdne_tpu_torch.cli import serve as serve_cli
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.diffusion import distillation as dist
from tqdne_tpu_torch.diffusion import edm
from tqdne_tpu_torch.diffusion.consistency import ConsistencyConfig
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.train.state import RAdam, TrainState, make_optimizer
from tqdne_tpu_torch.train.steps import training_sample

RTOL, ATOL = 1e-4, 1e-5
CM, EDM = jcons.ConsistencyConfig(), jedm.EDMConfig()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """The latent UNet over 8x8x8 with three sets of weights (student,
    teacher, EMA target) and the tiny autoencoder, both sides."""
    jm = JaxUNet(**TINY_2D)
    params = [random_params(jm, jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 5)),
                            seed=seed, std=0.05) for seed in (21, 22, 23)]
    ports = [load(UNet(**TINY_2D), p) for p in params]
    return jm, params, ports, tiny_ae_pair()


def test_edm_conditioned_net_and_teacher_step_match_jax(rng, models):
    """The student's network F(c_in x, 0.25 ln sigma) on the UNet, and one
    teacher Heun step from sigma_hi to sigma_lo through ``edm.precondition``."""
    jm, params, ports, _ = models
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    sigma = np.array([0.05, 20.0], np.float32)
    want = jax.jit(lambda p, x, s, c: jdist.edm_conditioned_net(jm, EDM, p)(x, s, c))(
        params[0], jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(cond))
    with torch.no_grad():
        got = dist.edm_conditioned_net(ports[0], edm.EDMConfig())(_t(x), _t(sigma), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    m = rng.standard_normal((8, 8)).astype(np.float32)
    lo = np.array([0.01, 15.0], np.float32)
    want = jdist.teacher_heun_step(
        EDM, lambda x, s, c: jedm.precondition(EDM, matrix_net(jnp, jnp.asarray(m)), x, s,
                                               cond=c),
        jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(lo), jnp.asarray(cond))
    got = dist.teacher_heun_step(
        edm.EDMConfig(), lambda x, s, c: edm.precondition(edm.EDMConfig(),
                                                          matrix_net(torch, _t(m)), x, s, cond=c),
        _t(x), _t(sigma), _t(lo), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def distill_draws(key, shape, n_grid=18):
    """The interval and the noise of ``jdist.distillation_loss`` for ``key``."""
    def draw(key):
        key_i, key_eps = jax.random.split(key)
        return (jax.random.randint(key_i, (shape[0],), 0, n_grid - 1),
                jax.random.normal(key_eps, shape))

    i, eps = jax.jit(draw)(key)
    return {"i": _t(i), "eps": _t(eps)}


def test_distillation_loss_matches_jax(rng):
    """The CD loss with three different toy networks (teacher, student,
    target) on JAX's interval and noise."""
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    cond = rng.standard_normal((3, 5)).astype(np.float32)
    ms = [rng.standard_normal((4, 4)).astype(np.float32) for _ in range(3)]
    key = jax.random.key(6)

    def nets(lib, conv):
        teacher = matrix_net(lib, conv(ms[0]))
        precondition = jedm.precondition if lib is jnp else edm.precondition
        cfg = EDM if lib is jnp else edm.EDMConfig()
        return (lambda x, s, c: precondition(cfg, teacher, x, s, cond=c),
                matrix_net(lib, conv(ms[1])), matrix_net(lib, conv(ms[2])))

    want = jdist.distillation_loss(CM, EDM, *nets(jnp, jnp.asarray), key, jnp.asarray(x), 18,
                                   cond=jnp.asarray(cond))
    got = dist.distillation_loss(ConsistencyConfig(), edm.EDMConfig(), *nets(torch, _t), _t(x),
                                 18, cond=_t(cond), **distill_draws(key, x.shape))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_latent_distill_train_step_matches_jax(rng, models):
    """One f32 ``latent_distill`` step: the frozen encoder (JAX's eps
    injected), the teacher's Heun step, the EMA target and the student, each
    with its own weights; then RAdam at 1e-4 and the target's EMA at 0.95."""
    jm, (student, teacher, target), ports, (jae, ae_params, port_ae) = models
    signal = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    key = jax.random.key(51)
    j_train, _, _ = jdist.make_distillation_steps(jm, optax.sgd(1.0), autoencoder=jae,
                                                  ema_decay=0.95)
    batch = {"signal": jnp.asarray(signal), "cond": jnp.asarray(cond)}
    want_loss, want_grads = jax_step(j_train, student, batch, key, ae_params, teacher,
                                     ema_params=target)
    key_ae, _, key_cd = jax.random.split(key, 3)
    draws = {"ae_eps": encoder_eps(jae, ae_params, batch["signal"], key_ae)}
    draws |= distill_draws(key_cd, tuple(draws["ae_eps"].shape))

    pbatch = {"signal": _t(signal), "cond": _t(cond)}
    frozen = copy.deepcopy(ports[1])
    unet = copy.deepcopy(ports[0])
    ema = copy.deepcopy(ports[2])
    sample = training_sample(pbatch, autoencoder=port_ae, ae_eps=draws["ae_eps"])
    loss = dist.distillation_loss(
        ConsistencyConfig(), edm.EDMConfig(),
        lambda x, s, c: edm.precondition(edm.EDMConfig(), frozen, x, s, cond=c),
        dist.edm_conditioned_net(unet, edm.EDMConfig(), train=True),
        dist.edm_conditioned_net(ema, edm.EDMConfig()), sample, 18, cond=pbatch["cond"],
        i=draws["i"], eps=draws["eps"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert all(p.grad is None for p in frozen.parameters())
    assert all(p.grad is None for p in ema.parameters())

    model = copy.deepcopy(ports[0])
    st = TrainState(model, make_optimizer("radam", model, 1e-4))
    st.ema.load_state_dict(ports[2].state_dict())
    train_step, _ = dist.make_distillation_steps(copy.deepcopy(ports[1]), autoencoder=port_ae,
                                                 ema_decay=0.95)
    check_step(lambda: train_step(st, pbatch, draws=draws), st, want_loss, want_grads, unet,
               optax.radam(1e-4), 0.95, student, target)
    assert not st.ema.training and st.model.training


@pytest.fixture(scope="module")
def jax_sampler(models):
    """The JAX ``sample_fn``'s network (the EMA target's CD parameterisation)
    and decoder, jitted once for every case."""
    jm, params, _, (jae, ae_params, _) = models
    return (jax.jit(lambda x, s, c: jdist.edm_conditioned_net(jm, EDM, params[2])(x, s, c)),
            jax.jit(lambda z: jae.apply(ae_params, z, method="decode")))


@pytest.mark.parametrize("noise,nfe", [("auto", 1), ("auto", 2), ("reference", 2)])
def test_distilled_sampler_matches_jax(rng, models, jax_sampler, noise, nfe):
    """``sample_distilled`` (the CD parameterisation, then the decoder)
    against the JAX ``sample_fn``'s body on the same injected draws."""
    _, _, ports, (_, _, port_ae) = models
    net, decode = jax_sampler
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    shape, sigmas, key = (2, 8, 8, 8), (0.6,) * (nfe - 1), jax.random.key(18)
    latent = jcons.consistency_sample(CM, net, key, shape, sigmas, None, jnp.asarray(cond),
                                      noise=noise)
    want = decode(latent)
    eps, refine = sampler_draws(key, shape, sigmas, "reference" if noise == "reference"
                                else "song")
    got = dist.sample_distilled(ports[2], shape, _t(cond), autoencoder=port_ae, sigmas=sigmas,
                                noise=noise, eps=eps, refine_draws=refine, device="cpu")
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(np.asarray(want)).max()))


def test_latent_cli_chain(tmp_path):
    """One workdir: ``autoencoder``, the ``latent_edm`` teacher, then
    ``latent_distill`` (RAdam, the target's EMA at --ema-decay; the student
    starts from the teacher's EMA weights and the teacher's run is left as it
    was; a missing ``--teacher`` is refused), the moments precomputed through
    ``--config latent_distill`` and ``latent_consistency --cached-latents``;
    then generate with ``--solver distill``, serve with ``--solver
    consistency`` (2 evals) and evaluate with ``--solver distill``."""
    wd = str(tmp_path)
    run = ["--workdir", wd, "--tiny", "--device", "cpu", "-b", "2", "--synthetic", "12",
           "--dtype", "f32", "--max-steps", "1"]
    train_cli.main(["autoencoder", *run])
    teacher = train_cli.main(["latent_edm", *run])
    teacher_sd = {k: v.clone() for k, v in teacher.ema.state_dict().items()}
    with pytest.raises(SystemExit, match="no checkpoint with its hparams.json under .*no-such-run"):
        train_cli.main(["latent_distill", *run, "--teacher", "no-such-run"])
    student = train_cli.main(["latent_distill", *run, "--ema-decay", "0.5"])
    assert isinstance(student.optimizer, RAdam) and student.lr_schedule is None
    # one RAdam step (1e-4 a parameter) from the teacher's weights; the frozen W stays
    moves = {k: (v - teacher_sd[k]).abs().max().item()
             for k, v in student.model.state_dict().items()}
    assert moves["time_embed.W"] == 0.0 and 0.0 < max(moves.values()) < 1e-3
    for k, v in student.ema.state_dict().items():  # EMA at 0.5: halfway to the new weights
        torch.testing.assert_close(v, 0.5 * teacher_sd[k] + 0.5 * student.model.state_dict()[k])
    run_dir = tmp_path / "outputs" / "Latent-Distill-32x32x8-LogSpectrogram"
    stored = json.loads((run_dir / "checkpoints" / "hparams.json").read_text())
    assert stored["kind"] == "distill"
    assert stored["teacher"] == "Latent-EDM-32x32x8-LogSpectrogram"
    reread = common.run_checkpoint(common.RECIPES["latent_edm"].config_cls(workdir=wd),
                                   "Latent-EDM-32x32x8-LogSpectrogram")[0]
    for k, v in reread.items():  # the teacher's run is untouched
        torch.testing.assert_close(v, teacher_sd[k])

    precompute_latents.main(["--workdir", wd, "--config", "latent_distill", "--tiny",
                             "--device", "cpu"])
    cached = train_cli.main(["latent_consistency", *run, "--cached-latents"])
    assert cached.step == 1 and isinstance(cached.optimizer, RAdam)

    out = tmp_path / "d.h5"
    generate_waveforms.main(["--solver", "distill", "--workdir", wd, "--device", "cpu",
                             "--num_samples", "2", "--hypocentral_distance", "50",
                             "--magnitude", "5", "--vs30", "400", "--hypocentre_depth", "10",
                             "--azimuthal_gap", "100", "--outfile", str(out), "--dtype", "f32",
                             "--gl-iters", "2"])
    with h5py.File(out) as f:
        assert f["waveforms"].shape == (2, 3, 4064) and np.isfinite(f["waveforms"][:]).all()

    args = serve_cli.parse_args(["--solver", "consistency", "--workdir", wd, "--device", "cpu",
                                 "--dtype", "f32", "--batch-size", "2", "--gl-iters", "2",
                                 "--port", "0"])
    assert (args.config, args.num_steps) == ("latent_consistency", 2)
    server, batcher = serve_cli.build_server(args)
    try:
        wave = batcher.generate(np.zeros((1, 5), np.float32), seed=1)
        assert wave.shape == (1, 3, 4064) and np.isfinite(wave).all()
    finally:
        server.server_close()
        batcher.shutdown()

    evaluate_cli.main(["--workdir", wd, "--solver", "distill", "--device", "cpu", "--dtype",
                       "f32", "-b", "2", "--limit-batches", "1", "--no-classifier"])
    h5 = tmp_path / "evaluation" / "Latent-Distill-32x32x8-LogSpectrogram-split_test-rank_0.h5"
    with h5py.File(h5) as f:
        prov = json.loads(f.attrs["provenance"])
        assert f["predicted_signal"].shape == (2, 3, 128, 128)
        assert np.isfinite(f["predicted_waveform"][:]).all()
    assert (prov["recipe"], prov["num_steps"], prov["solver"]) == ("latent_distill", 2,
                                                                    "distill")

