"""The port's training slice against the JAX package on the CPU: the EDM loss,
the autoencoder's encode and KL, one train step's loss and gradients, Adam +
cosine + EMA from a carried-over JAX state, the data path, the Trainer's
checkpoint/resume and the train CLI.

Every random draw is made on the JAX side exactly as its train step makes it
(``jax.random.split(key, 4)``, the autoencoder's ``make_rng("sample")``, the
EDM loss's sigma and noise keys) and injected into the port; dropout is 0.
The JAX UNet takes its Pallas route in interpret mode, so its gradients run
``_bwd_dkdv_kernel`` and ``_bwd_dq_kernel``.  f32 tolerance: rtol 1e-4 /
atol 1e-5, gradients rtol 1e-3 / atol 1e-4, unless a test says why.
"""

import copy
import json

import h5py
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from test_torch_port_models import SMALL_UNET, load, small_unet_pair
from tqdne_tpu import configs as jconfigs
from tqdne_tpu.cli.common import build_autoencoder as jax_build_autoencoder
from tqdne_tpu.data.dataset import Dataset as JaxDataset
from tqdne_tpu.data.dataset import make_synthetic_dataset as jax_make_synthetic_dataset
from tqdne_tpu.data.dataset import split_indices as jax_split_indices
from tqdne_tpu.diffusion import edm as jedm
from tqdne_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from tqdne_tpu.models.autoencoder import kl_divergence as jax_kl_divergence
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.train import state as jstate
from tqdne_tpu.train.steps import make_edm_steps as jax_make_edm_steps
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import train as train_cli
from tqdne_tpu_torch.data.dataset import ArrayDataset, Dataset, split_indices, synthetic_arrays
from tqdne_tpu_torch.data.pipeline import BatchLoader
from tqdne_tpu_torch.diffusion import edm
from tqdne_tpu_torch.models.autoencoder import AutoencoderKL, kl_divergence
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn.layers import set_compute_dtype
from tqdne_tpu_torch.train.checkpoint import Checkpointer
from tqdne_tpu_torch.train.loop import Trainer
from tqdne_tpu_torch.train.state import (
    TrainState,
    apply_updates,
    cosine_annealing,
    make_optimizer,
)
from tqdne_tpu_torch.train.steps import edm_step_loss, make_edm_steps, sample_edm
from tqdne_tpu_torch.utils import convert, randomize_

RTOL, ATOL = 1e-4, 1e-5
TINY_AE = dict(model_channels=8, channel_mult=(1, 2, 4), num_res_blocks=1,
               attention_resolutions=(), dims=2, conv_kernel_size=3)
ENC = TINY_AE | {"in_channels": 3, "out_channels": 16}  # 32x32x3 -> 8x8x8, SMALL_UNET's input
DEC = TINY_AE | {"in_channels": 8, "out_channels": 3}


def _t(a):
    return torch.from_numpy(np.array(a))


def tiny_ae_pair(seed=3, dtype=jnp.float32):
    """A 3-level 8-channel autoencoder on both sides, same seeded weights."""
    jm = JaxAutoencoderKL(encoder_config=ENC, decoder_config=DEC, dtype=dtype)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0),
                                             "sample": jax.random.key(0)},
                                            jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.1), shapes)
    return jm, params, load(AutoencoderKL(ENC, DEC), params)


def jax_step_draws(jae, ae_vars, signal, key, latent_shape, dtype=jnp.float32):
    """The standard-normal draws of the JAX train step for ``key``: the
    encoder's eps (from the AE's derived ``sample`` key), then the EDM
    loss's sigma normal and noise."""
    key_ae, _, key_edm, _ = jax.random.split(key, 4)
    k_eps = jae.apply(ae_vars, signal, method=lambda m, x: m.make_rng("sample"),
                      rngs={"sample": key_ae})
    key_sigma, key_noise = jax.random.split(key_edm)
    return {"ae_eps": jax.random.normal(k_eps, latent_shape, dtype),
            "sigma_eps": jax.random.normal(key_sigma, latent_shape[:1], dtype),
            "noise": jax.random.normal(key_noise, latent_shape, dtype)}


def as_torch(draws):
    return {k: _t(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in draws.items()}


def test_edm_loss_matches_jax(rng):
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    cond = rng.standard_normal((3, 5)).astype(np.float32)
    key = jax.random.key(11)

    def net(lib):  # a toy network using all three inputs
        def apply(x, c_noise, c):
            return lib.tanh(x) * c_noise[:, None, None, None] + c.sum(-1)[:, None, None, None]
        return apply

    want = jedm.edm_loss(jedm.EDMConfig(), net(jnp), key, jnp.asarray(x), cond=jnp.asarray(cond))
    key_sigma, key_noise = jax.random.split(key)
    got = edm.edm_loss(edm.EDMConfig(), net(torch), _t(x), cond=_t(cond),
                       sigma_eps=_t(jax.random.normal(key_sigma, (3,))),
                       noise=_t(jax.random.normal(key_noise, x.shape)))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    sigma = _t(np.array([0.01, 1.0, 60.0], np.float32))
    np.testing.assert_allclose(edm.loss_weight(edm.EDMConfig(), sigma).numpy(),
                               np.asarray(jedm.loss_weight(jedm.EDMConfig(),
                                                           jnp.asarray(sigma.numpy()))),
                               rtol=RTOL)


def test_encode_and_kl_divergence_match_jax(rng):
    jae, params, port = tiny_ae_pair()
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(4)
    want = jae.apply(params, jnp.asarray(x), method="encode", rngs={"sample": key})
    k_eps = jae.apply(params, jnp.asarray(x), method=lambda m, x: m.make_rng("sample"),
                      rngs={"sample": key})
    eps = _t(jax.random.normal(k_eps, want.shape))
    with torch.no_grad():
        got = port.encode(_t(x), eps=eps)
        mean, log_std = port.moments(_t(x))
        got_mean = port.encode_mean(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want_mean, want_log_std = jae.apply(params, jnp.asarray(x), method="moments")
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(kl_divergence(mean, log_std).numpy(),
                               np.asarray(jax_kl_divergence(want_mean, want_log_std)),
                               rtol=RTOL, atol=ATOL)


def _jax_loss(jm, jae):
    """JAX's loss as a function of (params, batch, key, ae_params): the EDM
    eval step, which is the train step's ``_loss`` with the same key split
    and no dropout, on the parameters it is given."""
    _, eval_step, _ = jax_make_edm_steps(jm, optax.adam(1e-4), autoencoder=jae)

    def loss(p, batch, key, ae_params):
        return eval_step(jstate.TrainState(0, p, p, None), batch, key, ae_params)["loss"]

    return loss


@pytest.fixture(scope="module")
def f32_pairs():
    jm, params, port_unet = small_unet_pair(seed=5)
    jae, ae_params, port_ae = tiny_ae_pair()
    return jm, params, port_unet, jae, ae_params, port_ae


def test_f32_train_step_loss_and_gradients_match_jax(rng, f32_pairs):
    """One f32 step of the latent EDM loss (frozen encoder, lognormal sigma,
    preconditioned UNet) and every parameter gradient, against
    jax.value_and_grad of the same loss with the same draws."""
    jm, params, port_unet, jae, ae_params, port_ae = f32_pairs
    signal = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    key = jax.random.key(21)
    batch = {"signal": jnp.asarray(signal), "cond": jnp.asarray(cond)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss(jm, jae)))(
        params, batch, key, ae_params)
    draws = as_torch(jax_step_draws(jae, ae_params, batch["signal"], key, (2, 8, 8, 8)))

    unet = copy.deepcopy(port_unet).train()
    loss = edm_step_loss(unet, {"signal": _t(signal), "cond": _t(cond)}, autoencoder=port_ae,
                         draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in unet.named_parameters():
        if not p.requires_grad:  # the frozen Fourier W: JAX stops its gradient
            assert p.grad is None and not want[name].any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_adam_cosine_and_ema_match_optax_from_a_carried_over_state(rng, f32_pairs):
    """Adam + the closed-form cosine schedule + the EMA lerp, three updates
    from the same gradients, starting from a JAX state two updates in that
    ``load_flax_train_state`` carries over.  Same params and EMA to 1e-6."""
    _, params, port_unet, *_ = f32_pairs
    schedule = jstate.cosine_annealing(1e-2, 6)
    tx = jstate.make_optimizer("adam", schedule)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        for _ in range(5)]
    grads = [{"params": {**g["params"], "time_embed": {"W": jnp.zeros_like(
        g["params"]["time_embed"]["W"])}}} for g in grads]  # W's gradient is stopped
    update = jax.jit(lambda state, g: jstate.apply_updates(state, g, tx, 0.9))
    state = jstate.TrainState.create(params, tx)
    for g in grads[:2]:
        state = update(state, g)

    model = copy.deepcopy(port_unet)
    port = TrainState(model, make_optimizer("adam", model, 1e-2), cosine_annealing(1e-2, 6))
    adam = state.opt_state[0]
    host = jax.tree_util.tree_map(np.asarray, (state.params, state.ema_params, adam.mu, adam.nu))
    convert.load_flax_train_state(port, *host, int(adam.count))
    assert port.step == 2
    for g in grads[2:]:
        state = update(state, g)
        sd = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g))
        for name, p in port.model.named_parameters():
            if p.requires_grad:
                p.grad = sd[name].clone()
        apply_updates(port, 0.9)
    for module, tree in ((port.model, state.params), (port.ema, state.ema_params)):
        want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))
        for name, t in module.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    assert port.step == int(state.step) == 5


def test_bf16_train_step_loss_matches_jax(rng):
    """bf16 compute over f32 parameters on both sides (the JAX ``dtype=bf16``
    modules), the draws made in bf16 as JAX makes them.  The frameworks round
    bf16 products in different places, and at this key's small sigmas (0.12,
    0.15) the loss weight of ~30 amplifies that: here bf16 alone moves JAX's
    loss 17% from its f32 value (1.107 against 1.333).  The bound is 5%, and
    every gradient lands in an f32 parameter."""
    _, params, port_unet = small_unet_pair(seed=5)
    jm = JaxUNet(**SMALL_UNET, use_pallas_norm=True, use_pallas_attention=True,
                 dtype=jnp.bfloat16)
    jae, ae_params, port_ae = tiny_ae_pair(dtype=jnp.bfloat16)
    signal = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    key = jax.random.key(22)
    batch = {"signal": jnp.asarray(signal), "cond": jnp.asarray(cond)}
    want_loss = jax.jit(_jax_loss(jm, jae))(params, batch, key, ae_params)
    draws = as_torch(jax_step_draws(jae, ae_params, batch["signal"], key, (2, 8, 8, 8),
                                    jnp.bfloat16))
    unet = set_compute_dtype(copy.deepcopy(port_unet), torch.bfloat16)
    loss = edm_step_loss(unet, {"signal": _t(signal), "cond": _t(cond)},
                         autoencoder=set_compute_dtype(port_ae, torch.bfloat16), draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=5e-2)
    for name, p in unet.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is None if not p.requires_grad else torch.isfinite(p.grad).all(), name


def test_cached_latent_moments_branch_matches_the_encoded_path(rng, f32_pairs):
    """``latent_moments=True`` samples mean + eps exp(log_std) from the batch's
    cached moments: with the same eps it is the encoded path's loss."""
    *_, port_unet, _, _, port_ae = f32_pairs
    signal = _t(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    cond = _t(rng.standard_normal((2, 5)).astype(np.float32))
    draws = {k: _t(rng.standard_normal(shape).astype(np.float32))
             for k, shape in (("ae_eps", (2, 8, 8, 8)), ("sigma_eps", (2,)),
                              ("noise", (2, 8, 8, 8)))}
    with torch.no_grad():
        mean, log_std = port_ae.moments(signal)
        want = edm_step_loss(port_unet, {"signal": signal, "cond": cond}, autoencoder=port_ae,
                             draws=draws)
        got = edm_step_loss(port_unet, {"latent_mean": mean, "latent_log_std": log_std,
                                        "cond": cond}, autoencoder=port_ae,
                            latent_moments=True, draws=draws)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sample_latent_edm_keeps_the_callers_dtype(rng):
    """``cast_params`` samples with a cast copy, as the JAX sample_fn casts
    a copy of its params: the caller's UNet stays float32."""
    _, _, port_unet = small_unet_pair(seed=5)
    _, _, port_ae = tiny_ae_pair()
    cond = _t(rng.standard_normal((1, 5)).astype(np.float32))
    out = sample_edm(port_unet, (1, 8, 8, 8), cond, autoencoder=port_ae, num_steps=2,
                     cast_params=torch.bfloat16, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 32, 32, 3) and torch.isfinite(out).all()
    assert {p.dtype for p in port_unet.parameters()} == {torch.float32}


def test_dataset_and_loader_match_jax(tmp_path):
    """The port's synthetic arrays equal the JAX package's file, the split
    is the same, and a batch read through both datasets agrees (the signal
    to the log-spectrogram tolerance, atol 1e-4)."""
    path = jax_make_synthetic_dataset(tmp_path / "d.h5", n=12, t=4064, seed=2)
    arrays = synthetic_arrays(12, t=4064, seed=2)
    with h5py.File(path) as f:
        assert set(f) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(f[k][:], v, err_msg=k)
    for split in ("train", "validation", "test", "train_validation", "full"):
        np.testing.assert_array_equal(split_indices(12, split), jax_split_indices(12, split))
    jconfig = jconfigs.LatentSpectrogramConfig(workdir=str(tmp_path))
    want = JaxDataset(path, jconfig.make_representation(), cut=4064, cond=True).load_batch(
        np.array([3, 0, 5]))
    rep = configs.LatentSpectrogramConfig().make_representation()
    got = Dataset(path, rep, cut=4064, cond=True).load_batch(np.array([3, 0, 5]))
    assert set(got) == set(want)
    for k in ("waveform", "cond", "valid_index"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["signal"], want["signal"], rtol=RTOL, atol=1e-4)

    loader = BatchLoader(ArrayDataset(arrays, rep, cut=4064, cond=True), 4,
                         keys=("signal", "cond"), device="cpu")
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    assert batches[0]["signal"].shape == (4, 128, 128, 3) and batches[0]["cond"].shape == (4, 5)


def test_batch_loader_reraises_a_loader_error():
    class Broken:
        def __len__(self):
            return 8

        def load_batch(self, idx, keys=None):
            raise OSError("bad read")

    with pytest.raises(OSError, match="bad read"):
        list(BatchLoader(Broken(), 4, device="cpu"))


def test_batch_loader_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, the loader puts batches on the
    card unless told otherwise, and says so where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = list(range(8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchLoader(ds, 4)
    assert BatchLoader(ds, 4, device="cpu").device == torch.device("cpu")


class _Patches:
    """(B, 3, 1024) waveforms -> (B, 3, 32, 32): a representation sized for
    the tiny autoencoder."""

    def get_representation(self, w):
        return w.reshape(w.shape[0], 3, 32, 32)


def _trainer_run(workdir, max_steps, arrays, resume=True):
    unet = randomize_(UNet(**SMALL_UNET), 9)
    _, _, ae = tiny_ae_pair()
    schedule = cosine_annealing(1e-3, 4)
    state = TrainState(unet, make_optimizer("adam", unet, 1e-3), schedule)
    train_step, eval_step = make_edm_steps(autoencoder=ae)
    train = BatchLoader(ArrayDataset(arrays, _Patches(), cond=True), 8, keys=("signal", "cond"),
                        prefetch=1, device="cpu")
    val = BatchLoader(ArrayDataset(arrays, _Patches(), cond=True, split="validation"), 1,
                      shuffle=False, keys=("signal", "cond"), device="cpu")
    trainer = Trainer(train_step, eval_step, workdir, device="cpu", max_epochs=10,
                      max_steps=max_steps, log_every=1, seed=3, lr_schedule=schedule,
                      hparams={"unet": SMALL_UNET})
    return trainer.fit(state, train, val, resume=resume)


def test_trainer_resume_is_exact_and_writes_the_jax_metric_keys(tmp_path):
    """4 steps in one run equal 2 steps, a checkpoint, a resume and 2 more
    (2 batches per epoch, a validation pass per epoch)."""
    rng = np.random.default_rng(1)
    arrays = {"waveforms": rng.standard_normal((20, 3, 1024)).astype(np.float32),
              "normalized_features": rng.standard_normal((20, 5)).astype(np.float32),
              "indices_valid_waveforms": np.full(20, 1024)}
    whole = _trainer_run(tmp_path / "whole", 4, arrays)
    _trainer_run(tmp_path / "split", 2, arrays)
    resumed = _trainer_run(tmp_path / "split", 4, arrays)
    assert whole.step == resumed.step == 4
    for a, b in ((whole.model, resumed.model), (whole.ema, resumed.ema)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)

    rows = [json.loads(line) for line in (tmp_path / "whole" / "metrics.jsonl").open()]
    assert {"step", "training/loss", "traintime", "lr"} <= set(rows[0])
    assert [r["step"] for r in rows if "training/loss" in r] == [0, 1, 2, 3]
    assert sum("validation/loss" in r for r in rows) == 2
    ckpt = tmp_path / "whole" / "checkpoints"
    assert [p.name for p in (ckpt / "last").glob("*.pt")] == ["4.pt"]
    assert len(json.loads((ckpt / "best" / "index.json").read_text())) == 2
    assert json.loads((ckpt / "progress.json").read_text()) == {"epoch": 2, "step": 4}
    assert json.loads((ckpt / "hparams.json").read_text())["unet"]["model_channels"] == 32
    with pytest.raises(ValueError, match="do not match"):  # a resume keeps its architecture
        Checkpointer(ckpt).verify_hyperparameters({"unet": SMALL_UNET | {"num_heads": 1}})


def test_train_cli_writes_metrics_and_a_checkpoint(tmp_path):
    """``latent_edm --synthetic 16 --tiny -b 4 --max-steps 2 --device cpu``
    with a converted tiny autoencoder, then resumed for a third step with
    the representation on the device and the non-finite guard armed;
    ``--cached-latents`` without a sidecar, an autoencoder recipe with
    cached latents and unported recipes are refused."""
    config = jconfigs.LatentSpectrogramConfig(workdir=str(tmp_path))
    ae, _, _ = jax_build_autoencoder(config, 2, model_channels=32)
    shapes = jax.eval_shape(lambda: ae.init({"params": jax.random.key(0),
                                             "sample": jax.random.key(0)},
                                            jnp.zeros((1, 128, 128, 3))))
    gen = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(gen.standard_normal(s.shape).astype(np.float32) * 0.02), shapes)
    (tmp_path / "ae.msgpack").write_bytes(serialization.to_bytes(params))
    convert.main([str(tmp_path / "ae.msgpack"), str(tmp_path / "ae.pt")])
    argv = ["latent_edm", "--workdir", str(tmp_path), "--synthetic", "16", "--tiny", "-b", "4",
            "--max-steps", "2", "--device", "cpu", "--ae-weights", str(tmp_path / "ae.pt")]
    train_cli.main(argv)
    run = tmp_path / "outputs" / train_cli.RUN_NAME
    rows = [json.loads(line) for line in (run / "metrics.jsonl").open()]
    assert [r["step"] for r in rows if "training/loss" in r] == [1]
    assert all(np.isfinite(r["training/loss"]) for r in rows if "training/loss" in r)
    assert any("validation/loss" in r for r in rows)
    assert (run / "checkpoints" / "last" / "2.pt").exists()
    state = train_cli.main([*argv[:-6], "--max-steps", "3", "--device-representation",
                            "--skip-nonfinite", "3", *argv[-4:]])
    assert state.step == 3 and (run / "checkpoints" / "last" / "3.pt").exists()
    with pytest.raises(SystemExit, match="not found"):
        train_cli.main(argv + ["--cached-latents"])
    with pytest.raises(SystemExit, match="needs a latent"):
        train_cli.main(["autoencoder", *argv[1:], "--cached-latents"])
    # the JAX CLI's refusal of a flag that would do nothing
    with pytest.raises(SystemExit, match="--device-representation is supported for EDM"):
        train_cli.main(["ddpm", *argv[1:], "--device-representation"])
