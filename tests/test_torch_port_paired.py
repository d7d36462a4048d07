"""Paired (``cond_signal``) data and training in the port, against the JAX
package on the CPU: ``PairedDataset`` over HDF5 files and in-memory tables
(the cases of ``tests/test_paired_dataset.py``), ``get_train_and_val_loader``,
the masking helpers (the cases of ``tests/test_masking.py``), the EDM step
(loss and gradients), its eval step and ``sample_edm`` with a latent
``cond_signal``, the autoencoder's ``cond_*`` losses, and the consistency,
distillation and DDPM samplers and steps with a ``cond_signal``.

Every draw is made on the JAX side as its function makes it and injected;
the JAX UNet takes its Pallas route in interpret mode, the samplers' toy
networks depend on each channel's place, so a swapped concatenation shows.
Tolerance: f32 rtol 1e-4 / atol 1e-5 (f64 accumulators for the EDM sampler);
gradients rtol 2e-3 / atol 2e-4.
"""

import h5py
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_consistency import consistency_draws, matrix_net, sampler_draws
from test_torch_port_models import load, random_params
from test_torch_port_train import tiny_ae_pair
from tqdne_tpu import configs as jconfigs
from tqdne_tpu.data import representation as jrep
from tqdne_tpu.data.dataloader import get_train_and_val_loader as jax_loaders
from tqdne_tpu.data.dataset import PairedDataset as JaxPairedDataset
from tqdne_tpu.diffusion import consistency as jcons
from tqdne_tpu.diffusion import ddpm as jddpm
from tqdne_tpu.diffusion import distillation as jdist
from tqdne_tpu.diffusion import edm as jedm
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.train import state as jstate
from tqdne_tpu.train import steps as jsteps
from tqdne_tpu.utils import masking as jmasking
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.data import representation as rep
from tqdne_tpu_torch.data.dataloader import get_train_and_val_loader
from tqdne_tpu_torch.data.dataset import PairedDataset, make_synthetic_dataset
from tqdne_tpu_torch.data.pipeline import BatchLoader, DeviceResidentLoader, to_channels_last
from tqdne_tpu_torch.diffusion import consistency as cons
from tqdne_tpu_torch.diffusion import ddpm
from tqdne_tpu_torch.diffusion import edm
from tqdne_tpu_torch.diffusion.distillation import make_distillation_steps, sample_distilled
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.train.state import TrainState, make_optimizer
from tqdne_tpu_torch.train.steps import (
    autoencoder_losses,
    edm_step_loss,
    make_edm_steps,
    sample_edm,
)
from tqdne_tpu_torch.utils import convert
from tqdne_tpu_torch.utils.masking import get_latent_mask_indexes, mask_from_indexes

RTOL, ATOL = 1e-4, 1e-5
N, C, T = 30, 3, 512


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the same
    cores, where a pool of spinning threads per process slows small CPU
    convolutions many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- PairedDataset --------------------------------------------------------------------


@pytest.fixture(scope="module")
def paired_tables():
    """The tables of ``tests/test_paired_dataset.py``: rows 0-4 below the SNR
    bound on every channel, rows 5-7 over the data-ratio bound, and here a
    NaN in every observed record."""
    rng = np.random.default_rng(0)
    tables = {}
    for name in ("obs", "syn"):
        snr = np.full((N, C), 5.0, np.float32)
        snr[:5] = 0.5
        ratio = np.ones(N, np.float32)
        ratio[5:8] = 50.0
        tables[name] = {"waveforms": rng.standard_normal((N, C, T)).astype(np.float32),
                        "snr": snr, "data_ratio": ratio}
    tables["obs"]["waveforms"][:, 1, 7] = np.nan
    return tables


@pytest.fixture(scope="module")
def paired_files(paired_tables, tmp_path_factory):
    path = tmp_path_factory.mktemp("paired")
    for name, table in paired_tables.items():
        with h5py.File(path / f"{name}.h5", "w") as f:
            for key, value in table.items():
                f.create_dataset(key, data=value)
    return path / "obs.h5", path / "syn.h5"


REPS = {"identity": (jrep.Identity, rep.Identity),
        "envelope": (jrep.MovingAverageEnvelope, rep.MovingAverageEnvelope)}


@pytest.mark.parametrize("source", ["hdf5", "memory"])
@pytest.mark.parametrize("representation,cut", [("identity", 256), ("identity", 1024),
                                                ("envelope", 512)])
def test_paired_dataset_matches_jax(paired_files, paired_tables, source, representation, cut):
    """The filters, the seed-42 90/10 split and the batches (cut, zero-padded,
    NaN as 0, rows in sorted order) equal the JAX class's on the same files;
    the port reads the in-memory tables the same way."""
    jrep_cls, rep_cls = REPS[representation]
    tables = paired_files if source == "hdf5" else (paired_tables["obs"], paired_tables["syn"])
    for training in (True, False):
        want = JaxPairedDataset(*paired_files, jrep_cls(), cut=cut, training=training)
        got = PairedDataset(*tables, rep_cls(), cut=cut, training=training)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert len(got) == len(want) == (19 if training else 3)
        assert set(got.indices).isdisjoint(range(8))
        asked = np.arange(len(got))[::-1]
        batch, ref = got.load_batch(asked), want.load_batch(asked)
        assert batch.keys() == ref.keys() == {"waveform", "cond_waveform", "signal",
                                              "cond_signal"}
        for key in batch:
            assert batch[key].dtype == np.float32 and batch[key].shape == ref[key].shape
            np.testing.assert_allclose(batch[key], ref[key], rtol=RTOL, atol=ATOL, err_msg=key)
        rows = np.sort(got.indices[asked])
        want_obs = np.nan_to_num(paired_tables["obs"]["waveforms"][rows][..., :cut])
        np.testing.assert_array_equal(batch["waveform"][..., :T], want_obs)
        assert np.isfinite(batch["waveform"]).all() and (batch["waveform"][:, 1, 7] == 0).all()
        if cut > T:
            assert (batch["signal"][..., T:] == 0).all()
        want.close()
        got.close()
    assert batch["signal"].shape[-1] == cut


def test_paired_batches_go_through_the_loaders_whole(paired_tables):
    """``BatchLoader`` and ``DeviceResidentLoader`` carry a paired batch whole:
    ``signal`` and ``cond_signal`` channels-last, ``cond_waveform``
    channels-first, as the JAX ``to_channels_last`` leaves it, and every row
    of a batch is one record's four columns.  (``load_batch`` sorts the rows
    it is asked for, so the resident loader, which gathers from the whole
    split read at once, draws its batches in another order than
    ``BatchLoader``, as the JAX loaders do.)"""
    ds = PairedDataset(paired_tables["obs"], paired_tables["syn"], rep.MovingAverageEnvelope(),
                       cut=T)
    keys = ("waveform", "cond_waveform", "signal", "cond_signal")
    full = to_channels_last(ds.load_batch(np.arange(len(ds))))
    for loader in (BatchLoader(ds, 4, device="cpu", prefetch=0, keys=keys),
                   DeviceResidentLoader(ds, 4, keys=keys, device="cpu")):
        batch = next(iter(loader))
        assert batch["signal"].shape == batch["cond_signal"].shape == (4, T, 2 * C)
        assert batch["waveform"].shape == (4, T, C)
        assert batch["cond_waveform"].shape == (4, C, T)
        for row in range(4):
            (j,) = np.flatnonzero(full["waveform"][:, 0, 0] == batch["waveform"][row, 0, 0].item())
            for key in keys:
                np.testing.assert_array_equal(batch[key][row].numpy(), full[key][j], key)


def test_train_and_val_loaders_match_jax(tmp_path):
    """``get_train_and_val_loader`` with ``mesh=None``: the same batches as
    the JAX one over the same file (the train split shuffled by epoch, the
    validation split in order), the waveforms exactly; a mesh is refused.
    The log-spectrograms to 1e-3: near the magnitude floor the log amplifies
    the two FFTs' f32 rounding (the representation is held in
    ``test_torch_port_generate.py``)."""
    jcfg = jconfigs.LatentSpectrogramConfig(workdir=str(tmp_path))
    cfg = configs.LatentSpectrogramConfig(workdir=str(tmp_path))
    assert str(cfg.datapath) == str(jcfg.datapath)
    make_synthetic_dataset(cfg.datapath, n=40, t=4096)
    kw = dict(cond=True, val_batch_size=2, keys=("waveform", "signal", "cond"))
    want = jax_loaders(jcfg, 8, **kw)
    got = get_train_and_val_loader(cfg, 8, device="cpu", **kw)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        for gb, wb in zip(g, w):
            assert gb.keys() == wb.keys() == set(kw["keys"])
            for key in ("waveform", "cond"):
                np.testing.assert_array_equal(gb[key].numpy(), np.asarray(wb[key]), key)
            np.testing.assert_allclose(gb["signal"].numpy(), np.asarray(wb["signal"]),
                                       rtol=RTOL, atol=1e-3)
    for loader in got:
        loader.dataset.close()
    with pytest.raises(ValueError, match="mesh"):
        get_train_and_val_loader(cfg, 8, mesh=object(), device="cpu")


# ---- masking --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["1d", "2d_nan", "latent"])
def test_masking_matches_jax(case):
    """The cases of ``tests/test_masking.py`` on both sides."""
    if case == "latent":
        idx = np.array([4064.0, 1000.0, 37.0], np.float32)
        got = get_latent_mask_indexes(_t(idx))
        want = jmasking.get_latent_mask_indexes(jnp.asarray(idx))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        low = int((((4064 - 8) / 2 - 8) / 2) - 3)
        assert int(got[0][0]) == low and int(got[1][0]) == ((low - 6) * 2 - 6) * 2
        with pytest.raises(ValueError):
            get_latent_mask_indexes(_t(idx), dim=1)
        return
    x = np.ones((2, 10, 3) if case == "1d" else (1, 8, 8, 3), np.float32)
    idx = np.array([4, 8]) if case == "1d" else np.array([5])
    kw = {"fill_with": 0.0} if case == "1d" else {}
    got = mask_from_indexes(_t(idx), _t(x), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmasking.mask_from_indexes(
        jnp.asarray(idx), jnp.asarray(x), **kw)))
    if case == "1d":
        assert got[0, :4].sum() == 12 and got[0, 4:].sum() == 0 and got[1, 8:].sum() == 0
    else:
        assert np.isfinite(got[0, :5]).all() and np.isnan(got[0, 5:]).all()


# ---- the EDM step and sampler with a latent cond_signal ----------------------------------

PAIRED_UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(4,),
                   channel_mult=(1, 2), num_heads=2, conv_kernel_size=3, dims=2,
                   in_channels=16, out_channels=8, cond_features=None)
LATENT = (2, 8, 8, 8)  # tiny_ae_pair's latent of a (2, 32, 32, 3) signal


@pytest.fixture(scope="module")
def paired_models():
    """The paired UNet (latent and encoded cond_signal in, latent out, no
    features) on the JAX kernel route and the port's, and the tiny
    autoencoder, same weights."""
    jm = JaxUNet(**PAIRED_UNET, use_pallas_norm=True, use_pallas_attention=True)
    params = random_params(JaxUNet(**PAIRED_UNET), jnp.zeros((1, 8, 8, 16)), jnp.zeros((1,)),
                           None, seed=11)
    jae, ae_params, port_ae = tiny_ae_pair()
    return jm, params, load(UNet(**PAIRED_UNET), params), jae, ae_params, port_ae


def _encoder_eps(jae, ae_params, x, key):
    """The standard normal the JAX encoder draws from its ``sample`` key."""
    k = jae.apply(ae_params, x, method=lambda m, x: m.make_rng("sample"), rngs={"sample": key})
    return _t(jax.random.normal(k, LATENT))


def test_precondition_puts_the_cond_signal_after_x(rng):
    """``precondition`` concatenates ``[c_in x, cond_signal]``, as the JAX
    one does; the other order gives another output."""
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    cs = rng.standard_normal((3, 4, 4, 1)).astype(np.float32)
    m = rng.standard_normal((3, 2)).astype(np.float32)
    sigma = np.array([0.01, 1.0, 60.0], np.float32)
    cond = np.zeros((3, 1), np.float32)
    want = jedm.precondition(jedm.EDMConfig(), matrix_net(jnp, jnp.asarray(m)), jnp.asarray(x),
                             jnp.asarray(sigma), cond_signal=jnp.asarray(cs),
                             cond=jnp.asarray(cond))
    got = edm.precondition(edm.EDMConfig(), matrix_net(torch, _t(m)), _t(x), _t(sigma),
                           cond_signal=_t(cs), cond=_t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    net = matrix_net(torch, _t(m))

    def sees_cond_signal_first(x_in, s, c):  # the input [cond_signal, x] would give it
        return net(torch.cat([x_in[..., 2:], x_in[..., :2]], dim=-1), s, c)

    swapped = edm.precondition(edm.EDMConfig(), sees_cond_signal_first, _t(x), _t(sigma),
                               cond_signal=_t(cs), cond=_t(cond))
    assert not np.allclose(swapped.numpy(), np.asarray(want), atol=1e-3)


def test_paired_edm_step_matches_jax(rng, paired_models):
    """One f32 latent EDM step on a paired batch: the frozen encoder encodes
    ``signal`` and ``cond_signal`` with their own draws (JAX's ``key_ae`` and
    ``key_ae2``); the loss and every gradient against JAX's, the eval step's
    loss the same; cached latents refuse a ``cond_signal`` as JAX does."""
    jm, params, port, jae, ae_params, port_ae = paired_models
    signal, cond_signal = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
                           for _ in range(2))
    batch = {"signal": jnp.asarray(signal), "cond_signal": jnp.asarray(cond_signal)}
    key = jax.random.key(31)
    _, j_eval, _ = jsteps.make_edm_steps(jm, optax.adam(1e-4), autoencoder=jae)

    def loss(p):
        return j_eval(jstate.TrainState(0, p, p, None), batch, key, ae_params)["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(params)
    key_ae, key_ae2, key_edm, _ = jax.random.split(key, 4)
    key_sigma, key_noise = jax.random.split(key_edm)
    draws = {"ae_eps": _encoder_eps(jae, ae_params, batch["signal"], key_ae),
             "cond_ae_eps": _encoder_eps(jae, ae_params, batch["cond_signal"], key_ae2),
             "sigma_eps": _t(jax.random.normal(key_sigma, (2,))),
             "noise": _t(jax.random.normal(key_noise, LATENT))}
    pbatch = {"signal": _t(signal), "cond_signal": _t(cond_signal)}
    got = edm_step_loss(port, pbatch, autoencoder=port_ae, draws=draws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in port.named_parameters():
        if not p.requires_grad:
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=name)
    port.zero_grad(set_to_none=True)
    _, eval_step = make_edm_steps(autoencoder=port_ae)
    state = TrainState(port, make_optimizer("adam", port, 1e-4))
    np.testing.assert_allclose(eval_step(state, pbatch, draws=draws)["loss"].item(),
                               float(want_loss), rtol=1e-5)

    cached = {"latent_mean": jnp.zeros(LATENT), "latent_log_std": jnp.zeros(LATENT),
              "cond_signal": batch["cond_signal"]}
    _, j_cached, _ = jsteps.make_edm_steps(jm, optax.adam(1e-4), autoencoder=jae,
                                           latent_moments=True)
    with pytest.raises(ValueError, match="cached latents do not support cond_signal") as jerr:
        j_cached(jstate.TrainState(0, params, params, None), cached, key, ae_params)
    with pytest.raises(ValueError) as err:
        edm_step_loss(port, {k: _t(v) for k, v in cached.items()}, autoencoder=port_ae,
                      latent_moments=True)
    assert str(err.value) == str(jerr.value)


def test_paired_sample_edm_matches_jax(rng, paired_models):
    """``sample_edm`` (dpmpp_2m, 3 steps, decoded) from a ``cond_signal``
    that the autoencoder first encodes stochastically (JAX's ``key_enc``
    draw), against the JAX ``sample_fn``, both with f64 accumulators."""
    jm, params, port, jae, ae_params, port_ae = paired_models
    cond_signal = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(41)
    *_, j_sample = jsteps.make_edm_steps(jm, optax.adam(1e-4), autoencoder=jae)
    key_enc, key_sample = jax.random.split(key)
    key_eps, _ = jax.random.split(key_sample)
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jax.jit(lambda p, k, cs, a: j_sample(
            p, k, LATENT, cond_signal=cs, ae_vars=a, num_steps=3, acc_dtype=jnp.float64,
            solver="dpmpp_2m"))(params, key, jnp.asarray(cond_signal), ae_params))
        noise = _t(jax.random.normal(key_eps, LATENT, jnp.float64))
    finally:
        jax.config.update("jax_enable_x64", False)
    cond_eps = _encoder_eps(jae, ae_params, jnp.asarray(cond_signal), key_enc)  # f32, as drawn
    assert noise.dtype == torch.float64
    got = sample_edm(port, LATENT, autoencoder=port_ae, num_steps=3, solver="dpmpp_2m",
                     cond_signal=_t(cond_signal), cond_eps=cond_eps, noise=noise, device="cpu")
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_autoencoder_losses_with_a_cond_signal_match_jax(rng):
    """The autoencoder reconstructs ``cond_signal`` too, with its own eps
    (JAX's ``key_s2``): every metric against JAX's, and the objective (and
    its gradients) against the JAX step's, which adds the ``cond_*`` terms.
    JAX's logged ``loss`` leaves them out; the port's ``loss`` is the
    objective."""
    jae, params, port = tiny_ae_pair()
    signal, cond_signal = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
                           for _ in range(2))
    key = jax.random.key(9)
    batch = {"signal": jnp.asarray(signal), "cond_signal": jnp.asarray(cond_signal)}
    _, eval_step = jsteps.make_autoencoder_steps(jae, optax.adam(1e-4), kl_weight=0.1)

    def objective(p):
        m = eval_step(jstate.TrainState(0, p, p, None), batch, key)
        return m["loss"] + m["cond_reconstruction_loss"] + 0.1 * m["cond_kl_divergence"], m

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
    key_s, key_s2, _ = jax.random.split(key, 3)
    draws = {"ae_eps": _t(jax.random.normal(key_s, LATENT)),
             "cond_ae_eps": _t(jax.random.normal(key_s2, LATENT))}
    got = autoencoder_losses(port, {"signal": _t(signal), "cond_signal": _t(cond_signal)},
                             kl_weight=0.1, draws=draws)
    got["loss"].backward()
    assert got.keys() == want.keys()
    for k in ("reconstruction_loss", "kl_divergence", "cond_reconstruction_loss",
              "cond_kl_divergence"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["loss"].item(), float(want_loss), rtol=RTOL, atol=ATOL)
    sd = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), sd[name].numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=name)


# ---- consistency, distillation and DDPM with a cond_signal -----------------------------


class MatrixNet(torch.nn.Module):
    """``matrix_net`` as a module, for the step factories and the samplers."""

    def __init__(self, m):
        super().__init__()
        self.m = torch.nn.Parameter(_t(m))

    def forward(self, x, sigma, c):
        return matrix_net(torch, self.m)(x, sigma, c)


class JaxMatrixNet:
    """``matrix_net`` as a flax-style ``apply(params, x, t, cond)``."""

    @staticmethod
    def apply(params, x, t, c):
        return matrix_net(jnp, params)(x, t, c)


def _toy(rng):
    x = rng.standard_normal((2, 8, 2)).astype(np.float32)
    cs = rng.standard_normal((2, 8, 1)).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    m = rng.standard_normal((3, 2)).astype(np.float32)
    return x, cs, cond, m


@pytest.mark.parametrize("nfe", [1, 2])
@pytest.mark.parametrize("kind", ["consistency", "distill"])
def test_few_eval_samplers_with_a_cond_signal_match_jax(rng, kind, nfe):
    """``consistency_sample`` and ``sample_distilled`` with a ``cond_signal``
    (``[x, cond_signal]`` at every eval; the distilled parameterisation's
    input scaling takes both, as in JAX) against JAX's sampling functions,
    its draws injected."""
    _, cs, cond, m = _toy(rng)
    shape, sigmas, key = (2, 8, 2), (0.7,) * (nfe - 1), jax.random.key(5)
    jnet = matrix_net(jnp, jnp.asarray(m)) if kind == "consistency" else \
        jdist.edm_conditioned_net(JaxMatrixNet, jedm.EDMConfig(), jnp.asarray(m))
    want = jcons.consistency_sample(jcons.ConsistencyConfig(), jnet, key, shape, sigmas,
                                    jnp.asarray(cs), jnp.asarray(cond))
    eps, refine = sampler_draws(key, shape, sigmas, "song")
    kw = dict(sigmas=sigmas, cond_signal=_t(cs), eps=eps, refine_draws=refine, device="cpu")
    if kind == "consistency":
        got = cons.sample_consistency(MatrixNet(m), shape, _t(cond), **kw)
    else:
        got = sample_distilled(MatrixNet(m), shape, _t(cond), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(np.asarray(want)).max()))


def test_ddpm_sample_with_a_cond_signal_matches_jax(rng):
    """``ddpm_sample`` at T = 20 with ``[cond_signal, x]`` at every step,
    against the JAX sampler with its draws injected."""
    _, cs, cond, _ = _toy(rng)
    m = rng.standard_normal((3, 2)).astype(np.float32)
    shape, key = (2, 8, 2), jax.random.key(6)
    jcfg = jddpm.DDPMConfig(num_train_timesteps=20)
    want = jax.jit(lambda k: jddpm.ddpm_sample(jcfg, matrix_net(jnp, jnp.asarray(m)), k, shape,
                                                cond_signal=jnp.asarray(cs),
                                                cond=jnp.asarray(cond)))(key)
    key_init, key_loop = jax.random.split(key)
    step_noise = [_t(jax.random.normal(k, shape)) for k in jax.random.split(key_loop, 20)]
    got = ddpm.ddpm_sample(ddpm.DDPMConfig(num_train_timesteps=20), matrix_net(torch, _t(m)),
                           shape, cond_signal=_t(cs), cond=_t(cond),
                           x=_t(jax.random.normal(key_init, shape)), step_noise=step_noise,
                           device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(np.asarray(want)).max()))


def test_step_factories_pass_the_cond_signal_as_jax_does(rng):
    """The consistency and DDPM train steps hand ``batch["cond_signal"]`` to
    their losses (against the JAX losses with the same draws); the
    distillation step, as JAX's, leaves it out of its loss."""
    x, cs, cond, m = _toy(rng)
    batch = {"signal": _t(x), "cond_signal": _t(cs), "cond": _t(cond)}
    key = jax.random.key(7)

    module = MatrixNet(m)
    train_step, _ = cons.make_consistency_steps(cons.ConsistencyConfig(), 16)
    draws = consistency_draws(key, x.shape, cons.num_timesteps(cons.ConsistencyConfig(), 0, 16))
    got = train_step(TrainState(module, make_optimizer("adam", module, 1e-4)), batch,
                     draws=draws)["loss"]
    net = matrix_net(jnp, jnp.asarray(m))
    want = jcons.consistency_loss(jcons.ConsistencyConfig(), net, net, key, jnp.asarray(x), 0,
                                  16, cond_signal=jnp.asarray(cs), cond=jnp.asarray(cond))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)

    module = MatrixNet(m)
    train_step, _ = ddpm.make_ddpm_steps(ddpm.DDPMConfig())
    key_t, key_n = jax.random.split(key)
    draws = {"t": _t(jax.random.randint(key_t, (2,), 0, 1000)),
             "noise": _t(jax.random.normal(key_n, x.shape))}
    got = train_step(TrainState(module, make_optimizer("adam", module, 1e-4)), batch,
                     draws=draws)["loss"]
    want = jddpm.ddpm_loss(jddpm.DDPMConfig(), matrix_net(jnp, jnp.asarray(m)), key,
                           jnp.asarray(x), cond_signal=jnp.asarray(cs), cond=jnp.asarray(cond))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)

    m2 = rng.standard_normal((2, 2)).astype(np.float32)
    losses = []
    for with_cs in (True, False):
        student = MatrixNet(m2)
        train_step, _ = make_distillation_steps(MatrixNet(m2))
        draws = {"i": torch.tensor([3, 11]), "eps": _t(jax.random.normal(key, x.shape))}
        b = batch if with_cs else {k: v for k, v in batch.items() if k != "cond_signal"}
        losses.append(train_step(TrainState(student, make_optimizer("adam", student, 1e-4)),
                                 b, draws=draws)["loss"].item())
    assert losses[0] == losses[1]
