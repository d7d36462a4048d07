"""The JAX UNet's and autoencoder's options in the port, against the JAX
package on the CPU: ``cond_emb_scale`` (a per-feature Fourier embedding of
the conditioning, here at F = 5 features), ``use_scale_shift_norm``,
``conv_resample=False`` and ``use_checkpoint``, each alone and all together,
1D and 2D; one f32 EDM train step of a checkpointed UNet with dropout on
against JAX's remat step; the autoencoder without resampling convolutions;
reference-layout state dicts with these options through both converters; and
a run whose ``hparams.json`` holds them, rebuilt by ``build_inference``.

Weights are random flax ``init`` shapes drawn from a numpy seed and carried
over by ``utils.convert``; the JAX side takes its Pallas route
(``use_pallas_norm=True, use_pallas_attention=True``) in interpret mode.
Dropout masks are JAX's own, read off its dropout layers and applied to the
port's.  Tolerance: f32 rtol 1e-4 / atol 1e-5; a step's loss to 1e-5
relative and every gradient to rtol 2e-3 / atol 2e-4 (the JAX package's own
gradient bound).
"""

import copy
import functools

import flax.linen as nn
import numpy as np
import pytest
import torch
from lightning_layout import reference_state_dict

import jax
import jax.numpy as jnp

from test_torch_port_models import load, random_params
from tqdne_tpu.diffusion import edm as jedm
from tqdne_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.utils import torch_convert as jconvert
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common
from tqdne_tpu_torch.models.autoencoder import AutoencoderKL
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn.layers import Downsample
from tqdne_tpu_torch.train.checkpoint import Checkpointer, hparams_diff
from tqdne_tpu_torch.train.state import TrainState, make_optimizer
from tqdne_tpu_torch.train.steps import edm_step_loss, sample_edm
from tqdne_tpu_torch.utils import convert, randomize_
from tqdne_tpu_torch.utils import torch_convert as port_convert

RTOL, ATOL = 1e-4, 1e-5
# two levels, attention in the middle block (16 tokens in 2D, 8 in 1D)
BASE = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(4,),
            channel_mult=(1, 2), num_heads=2, conv_kernel_size=3, cond_features=5)
SPATIAL = {1: (16,), 2: (8, 8)}
CHANNELS = 4
OPTIONS = {
    "cond_emb_scale": {"cond_emb_scale": 1.0},
    "scale_shift": {"use_scale_shift_norm": True},
    "no_conv_resample": {"conv_resample": False},
    "checkpoint": {"use_checkpoint": True},
    "all": {"cond_emb_scale": 1.0, "use_scale_shift_norm": True, "conv_resample": False,
            "use_checkpoint": True},
}


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


def unet_cfg(dims: int, option: str, **extra) -> dict:
    return BASE | {"dims": dims, "in_channels": CHANNELS, "out_channels": CHANNELS} | \
        OPTIONS[option] | extra


def unet_pair(cfg: dict, seed: int = 1):
    """The JAX UNet on its kernel route and the port's, same random weights
    (the shapes traced on the default route, which has the same parameters)."""
    jm = JaxUNet(**cfg, use_pallas_norm=True, use_pallas_attention=True)
    x = jnp.zeros((1, *SPATIAL[cfg["dims"]], cfg["in_channels"]))
    cond = None if cfg.get("cond_features") is None else jnp.zeros((1, cfg["cond_features"]))
    params = random_params(JaxUNet(**cfg), x, jnp.zeros((1,)), cond, seed=seed)
    return jm, params, load(UNet(**cfg), params)


def jax_forward(cfg: dict):
    """The jitted forward of the JAX UNet of ``cfg`` on its kernel route,
    compiled once a config."""
    return _jax_forward(tuple(sorted(cfg.items())))


@functools.cache
def _jax_forward(items):
    return jax.jit(JaxUNet(**dict(items), use_pallas_norm=True, use_pallas_attention=True).apply)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("dims", [1, 2])
def test_unet_option_matches_jax(rng, dims, option):
    """The UNet's forward with each option alone and all together, against
    the JAX UNet with the same flax parameters (``cond_embed.W`` and the
    2x-wide ``emb_proj`` included; no ``op``/``conv`` without resampling
    convolutions)."""
    cfg = unet_cfg(dims, option)
    jm, params, port = unet_pair(cfg)
    names = port.state_dict().keys()
    assert ("cond_embed.W" in names) == ("cond_emb_scale" in OPTIONS[option])
    assert any(k.endswith("_downsample.op.weight") for k in names) == cfg.get(
        "conv_resample", True)
    width = port.down_0_res.emb_proj.weight.shape[0]
    assert width == (2 if cfg.get("use_scale_shift_norm") else 1) * BASE["model_channels"]
    x = rng.standard_normal((2, *SPATIAL[dims], CHANNELS)).astype(np.float32)
    t = rng.standard_normal(2).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    want = jax_forward(cfg)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(cond))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_cond_embedding_flattens_feature_major(rng):
    """(B, F, M) -> (B, F*M) as flax's reshape: feature f's [sin | cos] at
    columns f*M .. (f+1)*M; a transposed flatten would differ at F = 5."""
    port = UNet(**unet_cfg(2, "cond_emb_scale"))
    cond = _t(rng.standard_normal((2, 5)).astype(np.float32))
    emb = port.cond_embed(cond)
    assert emb.shape == (2, 5, BASE["model_channels"])
    flat = emb.flatten(1)
    for f in range(5):
        torch.testing.assert_close(flat[:, f * 32:(f + 1) * 32], port.cond_embed(cond[:, f]))
    assert not torch.equal(flat, emb.transpose(1, 2).flatten(1))
    assert not port.cond_embed.W.requires_grad


def test_average_pool_downsample_keeps_its_channels():
    """A resample-free Downsample with other output channels fails, as the
    JAX module's assertion does; odd lengths drop their last row (VALID)."""
    with pytest.raises(ValueError, match="keeps its 8 channels"):
        Downsample(8, False, 2, 16)
    x = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    got = Downsample(3, False, 1)(x)
    torch.testing.assert_close(got, (x[..., 0:4:2] + x[..., 1:4:2]) / 2)


def _jax_dropout_masks(jm_plain, params, x, t, cond, key_drop) -> list:
    """The masks JAX's dropout layers draw from ``key_drop`` in a train-mode
    forward, in call order (flax's remat replays the same ones)."""
    def run(p, x, t, c):
        masks = []

        def intercept(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                masks.append(out != 0)
            return out

        with nn.intercept_methods(intercept):
            jm_plain.apply(p, x, t, c, train=True, rngs={"dropout": key_drop})
        return masks

    return [np.asarray(m) for m in jax.jit(run)(params, x, t, cond)]


def _apply_masks(unet, masks, rate):
    """Forward hooks giving each of ``unet``'s dropout layers the JAX mask
    (channels-last -> channels-first), on its recomputation too."""
    layers = [m for m in unet.modules() if isinstance(m, torch.nn.Dropout)]
    assert len(layers) == len(masks)
    by_layer = {m: _t(np.moveaxis(k, -1, 1)) for m, k in zip(layers, masks)}
    return [m.register_forward_hook(lambda mod, args, out: torch.where(
        by_layer[mod], args[0] / (1 - rate), 0.0)) for m in layers]


def test_remat_train_step_matches_jax(rng):
    """One f32 EDM step of the UNet with every option and dropout 0.2: the
    checkpointed port against JAX's ``nn.remat`` UNet, the loss and every
    gradient, with JAX's sigma, noise and dropout masks."""
    rate = 0.2
    cfg = unet_cfg(2, "all", dropout=rate)
    jm, params, port = unet_pair(cfg, seed=3)
    jm_plain = JaxUNet(**(cfg | {"use_checkpoint": False}))  # masks depend on the rng alone
    sample = rng.uniform(-1, 1, (2, 8, 8, CHANNELS)).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    key = jax.random.key(5)
    _, _, key_edm, key_drop = jax.random.split(key, 4)  # the JAX step's _loss

    def loss(p):
        def net(x, noise_cond, c):
            return jm.apply(p, x, noise_cond, c, train=True, rngs={"dropout": key_drop})
        return jedm.edm_loss(jedm.EDMConfig(), net, key_edm, jnp.asarray(sample),
                             cond=jnp.asarray(cond))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(params)
    masks = _jax_dropout_masks(jm_plain, params, jnp.asarray(sample), jnp.zeros(2),
                               jnp.asarray(cond), key_drop)
    assert all(0.1 < 1 - m.mean() < 0.3 for m in masks)
    key_sigma, key_noise = jax.random.split(key_edm)
    draws = {"sigma_eps": _t(jax.random.normal(key_sigma, (2,))),
             "noise": _t(jax.random.normal(key_noise, sample.shape))}
    unet = port.train()
    hooks = _apply_masks(unet, masks, rate)
    got = edm_step_loss(unet, {"signal": _t(sample), "cond": _t(cond)}, draws=draws)
    got.backward()
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(got.item(), float(want_loss), rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, p in unet.named_parameters():
        if not p.requires_grad:  # the frozen Fourier W: JAX stops their gradients
            assert p.grad is None and not want[name].any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=name)


def test_checkpointed_step_replays_the_dropout_masks(rng):
    """With dropout 0.5 and the same seed, the checkpointed UNet's loss and
    gradients equal the plain UNet's: the recomputation in the backward draws
    the forward's masks again (the RNG state is restored for it)."""
    cfg = unet_cfg(1, "checkpoint", dropout=0.5)
    plain = randomize_(UNet(**(cfg | {"use_checkpoint": False})), 4).train()
    remat = copy.deepcopy(plain)
    remat.use_checkpoint = True
    batch = {"signal": _t(rng.uniform(-1, 1, (2, 16, CHANNELS)).astype(np.float32)),
             "cond": _t(rng.standard_normal((2, 5)).astype(np.float32))}
    results = []
    for unet in (plain, remat):
        torch.manual_seed(7)
        loss = edm_step_loss(unet, batch, generator=torch.Generator().manual_seed(1))
        loss.backward()
        results.append((loss.item(), {n: p.grad for n, p in unet.named_parameters()
                                      if p.grad is not None}))
    assert results[0][0] == results[1][0]
    assert results[0][1].keys() == results[1][1].keys()
    for name, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], g, rtol=1e-6, atol=1e-7, msg=name)


@pytest.mark.parametrize("dims", [1, 2])
def test_autoencoder_without_resampling_convolutions_matches_jax(rng, dims):
    """``conv_resample=False``: the encoder average-pools and the decoder
    repeats; moments and decode against JAX with the same weights."""
    base = dict(model_channels=8, channel_mult=(1, 2, 4), num_res_blocks=1,
                attention_resolutions=(), dims=dims, conv_kernel_size=3, conv_resample=False)
    enc, dec = base | {"in_channels": 3, "out_channels": 8}, base | {"in_channels": 4,
                                                                      "out_channels": 3}
    spatial = (32,) * dims
    jm = JaxAutoencoderKL(encoder_config=enc, decoder_config=dec)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0),
                                             "sample": jax.random.key(0)},
                                            jnp.zeros((1, *spatial, 3))))
    gen = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(gen.standard_normal(s.shape).astype(np.float32) * 0.1), shapes)
    port = load(AutoencoderKL(enc, dec), params)
    assert not any("sample" in k for k in port.state_dict())
    x = rng.uniform(-1, 1, (2, *spatial, 3)).astype(np.float32)
    z = rng.standard_normal((2, *(8,) * dims, 4)).astype(np.float32)
    want_moments = jax.jit(lambda p, x: jm.apply(p, x, method="moments"))(params, jnp.asarray(x))
    want_dec = jax.jit(lambda p, z: jm.apply(p, z, method="decode"))(params, jnp.asarray(z))
    with torch.no_grad():
        got_moments = port.moments(_t(x))
        got_dec = port.decode(_t(z))
    for g, w in zip((*got_moments, got_dec), (*want_moments, want_dec)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    assert common.latent_shape(enc, (*spatial, 3)) == tuple(want_moments[0].shape[1:])


CONVERT_CASES = {  # the reference's embedding takes one feature (F = 1)
    "cond_embed": {"cond_features": 1, "cond_emb_scale": 1.0},
    "scale_shift": OPTIONS["scale_shift"],
    "no_conv_resample": OPTIONS["no_conv_resample"],
}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_torch_convert_of_the_options_matches_jax(rng, case):
    """A reference-layout state dict of a UNet with the option (the reference
    embeds one conditioning feature, F = 1) through the port's
    ``convert_unet``: the port's forward equals the JAX forward of the
    weights it came from.  The JAX converter gives the same tree where it
    reads the layout; it cannot read a model without resampling convolutions
    (it looks for their weights)."""
    cfg = BASE | {"dims": 2, "in_channels": CHANNELS, "out_channels": CHANNELS} | \
        CONVERT_CASES[case]
    jm, params, port = unet_pair(cfg, seed=8)
    sd = reference_state_dict(port, "unet")
    assert ("cond_embed.W" in sd) == (case == "cond_embed")
    converted = port_convert.convert_unet(sd, cfg)
    fresh = UNet(**cfg)
    fresh.load_state_dict(converted)  # strict: every name and shape
    x = rng.standard_normal((2, 8, 8, CHANNELS)).astype(np.float32)
    t = rng.standard_normal(2).astype(np.float32)
    cond = rng.standard_normal((2, cfg["cond_features"])).astype(np.float32)
    want = jax_forward(cfg)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = fresh.eval()(_t(x), _t(t), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if case == "no_conv_resample":
        with pytest.raises(KeyError, match="op.weight"):
            jconvert.convert_unet(sd, cfg)
        return
    tree = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             jconvert.convert_unet(sd, cfg)))
    assert tree.keys() == converted.keys()
    for key, value in converted.items():
        assert torch.equal(tree[key], value.float()), key


def test_torch_convert_of_a_resample_free_autoencoder(rng):
    """The autoencoder without resampling convolutions: the reference layout
    through ``convert_autoencoder`` back into the port, bit for bit."""
    config = configs.LatentSpectrogramConfig()
    ae, enc_cfg, dec_cfg = common.build_autoencoder(config, tiny=True, conv_resample=False)
    randomize_(ae, 9)
    sd = reference_state_dict(ae, "autoencoder")
    fresh = common.build_autoencoder(config, tiny=True, conv_resample=False)[0]
    fresh.load_state_dict(port_convert.convert_autoencoder(sd, enc_cfg, dec_cfg))
    for key, value in ae.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key


def test_conditioning_embedding_without_its_option_is_refused():
    cfg = BASE | {"dims": 2, "in_channels": CHANNELS, "out_channels": CHANNELS,
                  "cond_features": 1, "cond_emb_scale": 1.0}
    sd = reference_state_dict(UNet(**cfg), "unet")
    with pytest.raises(ValueError, match="cond_emb_scale"):
        port_convert.convert_unet(sd, cfg | {"cond_emb_scale": None})


def test_build_inference_rebuilds_a_run_with_the_options(tmp_path):
    """A latent run whose ``hparams.json`` holds every UNet option and an
    autoencoder run without resampling convolutions: ``hparams_diff`` finds
    nothing after the round trip, ``build_inference`` rebuilds both at their
    stored options and samples what ``sample_edm`` samples with them."""
    config = configs.LatentSpectrogramConfig(workdir=str(tmp_path))
    ae, enc_cfg, dec_cfg = common.build_autoencoder(config, tiny=True, conv_resample=False)
    ucfg = configs.get_2d_unet_config(config, 8, 8, model_channels=common.TINY_CHANNELS) | \
        OPTIONS["all"]
    unet = UNet(**ucfg)
    runs = ((common.AE_NAME, ae, common.autoencoder_hparams(config, enc_cfg, dec_cfg)),
            (common.RUN_NAME, unet, {"kind": "edm", "dims": 2, "latent": True, "unet": ucfg}))
    for i, (name, module, hparams) in enumerate(runs):
        randomize_(module, 20 + i)
        ckpt = Checkpointer(tmp_path / "outputs" / name / "checkpoints")
        ckpt.save(3, TrainState(module, make_optimizer("adam", module, 1e-4)))
        ckpt.save_hyperparameters(hparams)
        assert hparams_diff(ckpt.restore_hyperparameters(), hparams) == []
    bundle = common.build_inference(workdir=tmp_path, dtype=torch.float32, num_steps=2,
                                    solver="dpmpp_2m", device="cpu")
    assert bundle.unet.cond_embed is not None and bundle.unet.use_checkpoint
    assert bundle.unet.mid_res1.emb_proj.weight.shape[0] == 2 * ucfg["model_channels"] * 4
    ups = [m for n, m in bundle.autoencoder.named_modules() if n.endswith("_upsample")]
    assert ups and all(m.conv is None for m in ups)
    assert bundle.model_shape == (32, 32, 8)
    cond = torch.zeros(1, 5)
    noise = torch.randn(1, *bundle.model_shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = bundle.sample(cond, noise=noise)
        want = sample_edm(unet.eval(), (1, *bundle.model_shape), cond, autoencoder=ae.eval(),
                          num_steps=2, solver="dpmpp_2m", noise=noise, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
