"""The port's layers and models against the JAX package on the CPU.

Weights go from flax ``Module.init`` (randomised so zero-init layers do
work) or a committed artifact through ``tqdne_tpu_torch.utils.convert``;
the JAX side takes its Pallas route (``use_pallas*=True``) in interpret
mode.  Tensors cross as numpy in the JAX layout (channels last).
Tolerance: f32 at rtol 1e-4 / atol 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tqdne_tpu.cli.export_weights import load_exported
from tqdne_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from tqdne_tpu.models.unet import ResBlock as JaxResBlock
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.nn.attention import AttentionBlock as JaxAttentionBlock
from tqdne_tpu.nn.layers import GaussianFourierProjection as JaxFourier
from tqdne_tpu.nn.layers import Norm32 as JaxNorm32
from tqdne_tpu.nn.layers import conv_nd as jax_conv_nd
from tqdne_tpu_torch.models.autoencoder import AutoencoderKL
from tqdne_tpu_torch.models.unet import ResBlock, UNet
from tqdne_tpu_torch.nn.attention import AttentionBlock
from tqdne_tpu_torch.nn.layers import GaussianFourierProjection, Norm32, conv_nd
from tqdne_tpu_torch.utils.convert import flax_to_state_dict, read_msgpack

RTOL, ATOL = 1e-4, 1e-5
AE_WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / \
    "Autoencoder-32x32x4-LogSpectrogram-ema.msgpack"


def random_params(module, *args, seed=1, std=0.1):
    """Parameters of ``module.init(*args)``'s structure drawn from a seeded
    normal (zero-init layers and unit norms do work too); only the shapes
    are traced, nothing is compiled."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * std), shapes)


def load(module, params):
    module.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return module.eval()


def first(x):
    """Channels-last numpy -> channels-first tensor (the port's inner layout)."""
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 1).copy())


def last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.mark.parametrize("channels,silu", [(64, True), (128, False), (48, True)])
def test_norm32_matches_jax(rng, channels, silu):
    x = (rng.standard_normal((2, 6, 6, channels)) * 3 + 1).astype(np.float32)
    jm = JaxNorm32(silu=silu, use_pallas=True)
    params = random_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    got = load(Norm32(channels, silu=silu), params)(first(x))
    np.testing.assert_allclose(last(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dims,stride,kernel", [(2, 1, 3), (2, 2, 3), (1, 1, 5), (1, 2, 5),
                                                (2, 1, 1)])
def test_conv_nd_matches_jax(rng, dims, stride, kernel):
    x = rng.standard_normal((2, *(16,) * dims, 6)).astype(np.float32)
    jm = jax_conv_nd(dims, 10, kernel, stride=stride)
    params = random_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    got = load(conv_nd(dims, 6, 10, kernel, stride=stride), params)(first(x))
    assert last(got).shape == want.shape
    np.testing.assert_allclose(last(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_fourier_projection_matches_jax(rng):
    t = rng.standard_normal(4).astype(np.float32)
    jm = JaxFourier(32)
    params = random_params(jm, jnp.asarray(t), std=0.02)
    want = jm.apply(params, jnp.asarray(t))
    got = load(GaussianFourierProjection(32), params)(torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads,causal", [(2, False), (4, True)])
def test_attention_block_matches_jax(rng, heads, causal):
    x = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    jm = JaxAttentionBlock(64, num_heads=heads, use_causal_mask=causal, use_pallas=True)
    params = random_params(jm, jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    got = load(AttentionBlock(64, heads, use_causal_mask=causal), params)(first(x))
    np.testing.assert_allclose(last(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resblock_matches_jax(rng, cin, cout):
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    emb = rng.standard_normal((2, 128)).astype(np.float32)
    jm = JaxResBlock(cin, 128, out_channels=cout, use_pallas_norm=True)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(emb))
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(emb))
    got = load(ResBlock(cin, 128, out_channels=cout), params)(first(x), torch.from_numpy(emb))
    np.testing.assert_allclose(last(got), np.asarray(want), rtol=RTOL, atol=ATOL)


SMALL_UNET = dict(in_channels=8, out_channels=8, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(2,), channel_mult=(1, 2, 2), num_heads=2,
                  conv_kernel_size=3, dims=2, cond_features=5)


def small_unet_pair(seed=1):
    """A 3-level JAX UNet on its kernel route and the port's, same weights."""
    jm = JaxUNet(**SMALL_UNET, use_pallas_norm=True, use_pallas_attention=True)
    x = jnp.zeros((1, 8, 8, 8))
    params = random_params(jm, x, jnp.zeros((1,)), jnp.zeros((1, 5)), seed=seed)
    return jm, params, load(UNet(**SMALL_UNET), params)


def test_unet_matches_jax(rng):
    jm, params, port = small_unet_pair()
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    t = rng.standard_normal(2).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def trained_ae():
    """The committed trained autoencoder on both sides: JAX through the
    package's own loader, the port through its msgpack converter."""
    params, manifest = load_exported(str(AE_WEIGHTS))
    hp = manifest["hparams"]
    enc = {k: tuple(v) if isinstance(v, list) else v for k, v in hp["encoder"].items()}
    dec = {k: tuple(v) if isinstance(v, list) else v for k, v in hp["decoder"].items()}
    port = AutoencoderKL(enc, dec)
    port.load_state_dict(flax_to_state_dict(read_msgpack(AE_WEIGHTS)))
    return JaxAutoencoderKL(encoder_config=enc, decoder_config=dec), params, port.eval()


def test_decoder_matches_jax_with_trained_weights(rng, trained_ae):
    jm, params, port = trained_ae
    z = rng.standard_normal((1, 32, 32, 8)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(z), method="decode"))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 128, 128, 3)
    # outputs reach ~5 after a 13-conv stack: absolute error scales with them
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_encoder_moments_match_jax_with_trained_weights(rng, trained_ae):
    jm, params, port = trained_ae
    x = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), method="moments")
    with torch.no_grad():
        got = port.moments(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 32, 32, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-4)


def test_unet_bf16_cast_semantics_match_jax(rng):
    """bf16 as the sampler runs it: parameters cast once, f32 inputs, f32 out.
    The two frameworks accumulate bf16 products in different orders; here that
    differs by ~0.9% of the output's peak, about as much as bf16 differs from
    f32, so the bound is 2% of the peak."""
    _, params, port = small_unet_pair()
    jm = JaxUNet(**SMALL_UNET, use_pallas_norm=True, use_pallas_attention=True,
                 dtype=jnp.bfloat16)
    params16 = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    t = rng.standard_normal(2).astype(np.float32)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params16, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(cond)))
    with torch.no_grad():
        got = port.to(torch.bfloat16)(torch.from_numpy(x), torch.from_numpy(t),
                                      torch.from_numpy(cond))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.02 * np.abs(want).max())
