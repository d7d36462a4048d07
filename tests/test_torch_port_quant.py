"""The port's int8 mode (``tqdne_tpu_torch/nn/quant.py``) against the JAX
package's ``QuantConv`` on the CPU.

- ``quantize_symmetric`` bit for bit against the JAX one, the zero guard and
  the range case of ``tests/test_quant.py:62-69`` included;
- ``quant_conv`` on each case of ``tests/test_quant.py:25-33`` against JAX
  ``QuantConv.apply`` on the same weights: identical int8 codes and scales,
  the output to f32 rtol 1e-5 (the int32 sums are exact on both sides; only the
  f32 dequantization's rounding may differ); the bf16 activation case to one
  bf16 rounding of the same f32 values (rtol 2^-8);
- the card's route (im2col then ``torch._int_mm``) on the CPU against the plain
  float64 convolution, bit for bit, at depths and widths that are not multiples
  of 8;
- the port's UNet under ``int8_scope`` against the JAX UNet under its
  ``int8_scope`` with the config of ``tests/test_quant.py:77-79`` and its zero
  leaves filled as there: within 2e-3 of the output's peak (measured 6.7e-8
  here, with no code rounding the other way; the two f32 stacks differ at
  rounding, 3.4e-7 of the peak without int8, and an activation that lands
  within that of a code boundary rounds to the next code, a step of
  amax / 127 that the layers after it carry on: the bound leaves room for a
  few such codes under another thread count), and the JAX test's own gate,
  cosine > 0.98 against the f32 path (0.99966);
- ``TQDNE_INT8_CONV=1`` taking the same route as the scope, the weights bridge
  unchanged (the same state dict loads into either mode), the three CLIs'
  ``--int8`` on tiny CPU bundles, and the classifier left unquantized inside an
  int8 evaluation.
"""

import os

import flax.linen as fnn
import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_1d import one_torch_thread  # noqa: F401 - an autouse fixture
from test_torch_port_recipes import TINY_CLF
from tqdne_tpu.models.unet import UNet as JaxUNet
from tqdne_tpu.nn import quant as jquant
from tqdne_tpu_torch import configs
from tqdne_tpu_torch.cli import common, evaluate, generate_waveforms
from tqdne_tpu_torch.cli import serve as serve_cli
from tqdne_tpu_torch.data.dataset import make_synthetic_dataset
from tqdne_tpu_torch.models.classifier import Classifier
from tqdne_tpu_torch.models.unet import UNet
from tqdne_tpu_torch.nn import layers
from tqdne_tpu_torch.nn.quant import (
    int8_enabled,
    int8_scope,
    int_conv_mm,
    int_conv_plain,
    quant_conv,
    quantize_symmetric,
)
from tqdne_tpu_torch.utils import randomize_
from tqdne_tpu_torch.utils.convert import flax_to_state_dict

QCONV_CASES = [  # tests/test_quant.py:25-33
    (1, (2, 64, 16), 3, 1, "SAME"),
    (2, (2, 16, 16, 8), 3, 1, "SAME"),
    (2, (2, 16, 16, 8), 3, 2, [(1, 1), (1, 1)]),
    (1, (2, 64, 16), 1, 1, "SAME"),
    (1, (2, 64, 16), 3, 2, [(1, 1)]),
]
UNET_CFG = dict(model_channels=16, num_res_blocks=1, channel_mult=(1, 2),  # test_quant.py:77-79
                attention_resolutions=(), dims=1, cond_features=5, in_channels=3,
                out_channels=3)
UNET_BOUND = 2e-3


def _torch_kernel(kernel) -> torch.Tensor:
    """A flax (*window, in, out) kernel as torch's (out, in, *window)."""
    k = np.asarray(kernel)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(k, (-1, -2), (0, 1))))


def test_quantize_symmetric_matches_jax_bit_for_bit(rng):
    x = rng.standard_normal((4, 8, 16)).astype(np.float32) * 3
    for axes in ((0, 1, 2), (0, 1), (2,)):
        jq, js = jquant.quantize_symmetric(jnp.asarray(x), axes=axes)
        q, s = quantize_symmetric(torch.from_numpy(x), axes)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the zero guard and the range case of tests/test_quant.py:62-69
    q, s = quantize_symmetric(torch.zeros(4, 4), (0, 1))
    assert int(q.abs().max()) == 0 and torch.isfinite(s).all()
    x = torch.tensor([[-3.0, 0.5], [1.0, 3.0]])
    q, s = quantize_symmetric(x, (0, 1))
    jq, js = jquant.quantize_symmetric(jnp.asarray(x.numpy()), axes=(0, 1))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert int(q.int().abs().max()) == 127
    assert float((q.float() * s - x).abs().max()) < 3.0 / 127 + 1e-6
    # half to even, as jnp.round: 0.5 and 2.5 round down, 1.5 up
    q, _ = quantize_symmetric(torch.tensor([0.5, 1.5, 2.5, 127.0]), (0,))
    assert q.tolist() == [0, 2, 2, 127]


@pytest.mark.parametrize("dims,shape,k,stride,pad", QCONV_CASES)
def test_quant_conv_matches_jax_quantconv(rng, dims, shape, k, stride, pad):
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    ref = fnn.Conv(features=24, kernel_size=(k,) * dims, strides=(stride,) * dims, padding=pad)
    variables = ref.init(jax.random.key(0), x)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.2),
        variables)
    q = jquant.QuantConv(features=24, kernel_size=(k,) * dims, strides=(stride,) * dims,
                         padding=pad)
    want = np.asarray(q.apply(params, x))
    kernel, bias = params["params"]["kernel"], params["params"]["bias"]
    w, b = _torch_kernel(kernel), torch.from_numpy(np.asarray(bias))
    xt = torch.from_numpy(np.asarray(x)).movedim(-1, 1)
    # the codes and scales of both operands
    jxq, jxs = jquant.quantize_symmetric(x, axes=tuple(range(x.ndim)))
    jwq, jws = jquant.quantize_symmetric(kernel, axes=tuple(range(kernel.ndim - 1)))
    xq, xs = quantize_symmetric(xt, tuple(range(xt.ndim)))
    wq, ws = quantize_symmetric(w, tuple(range(1, w.ndim)))
    np.testing.assert_array_equal(xq.movedim(1, -1).numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), _torch_kernel(jwq).numpy())
    np.testing.assert_array_equal(xs.numpy().ravel(), np.asarray(jxs).ravel())
    np.testing.assert_array_equal(ws.numpy().ravel(), np.asarray(jws).ravel())
    got = quant_conv(xt, w, b, stride, k // 2).movedim(1, -1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_quant_conv_bf16_activations_match_jax(rng):
    x = jnp.asarray(rng.standard_normal((2, 32, 16)), jnp.bfloat16)
    q = jquant.QuantConv(features=8, kernel_size=(3,), strides=(1,), padding="SAME")
    v = q.init(jax.random.key(0), x)
    want = q.apply(v, x)
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16).movedim(-1, 1)
    got = quant_conv(xt, _torch_kernel(v["params"]["kernel"]),
                     torch.from_numpy(np.asarray(v["params"]["bias"])), 1, 1).movedim(1, -1)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("dims,x_shape,out,k,stride", [
    (1, (3, 3, 40), 5, 3, 1),    # depth 3 x 3 = 9 and width 5: both padded
    (1, (2, 13, 64), 10, 5, 2),  # depth 65, width 10
    (2, (2, 3, 9, 7), 3, 3, 1),  # the in and out convolutions' 27 and 3
    (2, (2, 8, 16, 16), 12, 3, 2),
    (2, (1, 5, 4, 4), 7, 1, 1),  # 16 rows: padded past torch._int_mm's 16
])
def test_int_mm_route_matches_the_plain_convolution(dims, x_shape, out, k, stride):
    """``int_conv_mm`` (the card's route) runs on the CPU too: the same int32
    sums as the float64 convolution of the codes, bit for bit."""
    gen = torch.Generator().manual_seed(sum(x_shape) + out)
    xq = torch.randint(-127, 128, x_shape, generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (out, x_shape[1], *(k,) * dims), generator=gen,
                       dtype=torch.int8)
    got, want = int_conv_mm(xq, wq, stride, k // 2), int_conv_plain(xq, wq, stride, k // 2)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    # the extreme codes everywhere: sums of 127^2 K, exact in int32 and in float64
    full = torch.full_like(xq, 127), torch.full_like(wq, -127)
    assert torch.equal(int_conv_mm(*full, stride, k // 2), int_conv_plain(*full, stride, k // 2))


@pytest.fixture(scope="module")
def unet_pair():
    """The JAX UNet of ``tests/test_quant.py:77-79`` with its zero leaves filled
    as there, and the port's UNet on the same weights (the bridge unchanged)."""
    x = jax.random.normal(jax.random.key(1), (2, 64, 3))
    sigma, cond = jnp.ones((2,)), jnp.zeros((2, 5))
    jm = JaxUNet(**UNET_CFG)

    @jax.jit
    def init_filled(x, sigma, cond):  # tests/test_quant.py:85-92, traced once
        leaves, treedef = jax.tree_util.tree_flatten(jm.init(jax.random.key(0), x, sigma, cond))
        keys = jax.random.split(jax.random.key(7), len(leaves))
        return jax.tree_util.tree_unflatten(treedef, [
            jnp.where(jnp.all(leaf == 0), jax.random.normal(k, leaf.shape) * 0.05, leaf)
            for leaf, k in zip(leaves, keys)])

    v = init_filled(x, sigma, cond)
    port = UNet(**UNET_CFG)
    port.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, port.eval(), (x, sigma, cond)


def _port_forward(port, inputs):
    x, sigma, cond = (torch.from_numpy(np.array(a)) for a in inputs)
    with torch.no_grad():
        return port(x, sigma, cond).numpy()


def test_int8_unet_matches_jax_and_tracks_f32(unet_pair):
    jm, v, port, inputs = unet_pair
    with jquant.int8_scope():  # read while jit traces the UNet
        want = np.asarray(jax.jit(jm.apply)(v, *inputs))
    with int8_scope():
        assert int8_enabled()
        got = _port_forward(port, inputs)
    f32 = _port_forward(port, inputs)
    assert not int8_enabled()
    assert got.shape == want.shape == (2, 64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=UNET_BOUND * np.abs(want).max())
    a, b = f32.ravel(), got.ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    assert cos > 0.98, cos
    assert not np.array_equal(got, f32)


def test_env_variable_takes_the_int8_route_and_the_bridge_is_unchanged(unet_pair,
                                                                       monkeypatch):
    """``TQDNE_INT8_CONV=1`` routes every convolution as the scope does; the
    parameter names do not change, so one state dict loads into either mode (the
    JAX test's tree-structure check, ``tests/test_quant.py:42-44``)."""
    _, v, port, inputs = unet_pair
    with int8_scope():
        scoped = _port_forward(port, inputs)
    calls = []
    real = layers.quant_conv
    monkeypatch.setattr(layers, "quant_conv", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("TQDNE_INT8_CONV", "1")
    assert int8_enabled()
    env = _port_forward(port, inputs)
    convs = sum(isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)) for m in port.modules())
    assert len(calls) == convs > 10
    np.testing.assert_array_equal(env, scoped)
    fresh = UNet(**UNET_CFG)
    assert fresh.state_dict().keys() == port.state_dict().keys()
    fresh.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, v)))
    np.testing.assert_array_equal(_port_forward(fresh.eval(), inputs), env)
    monkeypatch.delenv("TQDNE_INT8_CONV")
    assert not int8_enabled()


def _tiny_weights(tmp_path):
    bundle = common.build_inference(dtype=torch.float32, device="cpu", tiny=True)
    torch.save(randomize_(bundle.unet, 0).state_dict(), tmp_path / "unet.pt")
    torch.save(randomize_(bundle.autoencoder, 1).state_dict(), tmp_path / "ae.pt")
    return ["--unet-weights", str(tmp_path / "unet.pt"), "--ae-weights", str(tmp_path / "ae.pt")]


def test_generate_and_serve_take_int8(tmp_path):
    """``generate --int8`` writes the int8 bundle's waveforms (finite, not the
    f32 ones); ``serve --int8`` builds an int8 bundle and reports it."""
    weights = _tiny_weights(tmp_path)
    argv = ["--tiny", "--device", "cpu", "--dtype", "f32", "--num-steps", "2", "--solver",
            "dpmpp_2m", "--gl-iters", "2", *weights, "--hypocentral_distance", "50",
            "--magnitude", "5.5", "--vs30", "400", "--hypocentre_depth", "20",
            "--azimuthal_gap", "100", "--num_samples", "2"]
    waves = {}
    for flag in ([], ["--int8"]):
        out = tmp_path / f"gen{len(flag)}.h5"
        generate_waveforms.main([*argv, "--outfile", str(out), *flag])
        with h5py.File(out, "r") as f:
            waves[bool(flag)] = f["waveforms"][:]
    assert np.isfinite(waves[True]).all() and not np.array_equal(waves[True], waves[False])
    args = serve_cli.parse_args(["--tiny", "--device", "cpu", "--num-steps", "2", "--solver",
                                 "dpmpp_2m", "--gl-iters", "1", "--dtype", "f32",
                                 "--batch-size", "2", "--port", "0", "--int8", *weights])
    server, batcher = serve_cli.build_server(args)
    try:
        assert batcher.batches_run == 1  # the warm-up
        bundle = serve_cli.build_bundle(args)
        assert bundle.int8 and bundle.mesh is None
    finally:
        server.server_close()
        batcher.shutdown()


def test_int8_evaluation_keeps_the_classifier_unquantized(tmp_path):
    """``evaluate --int8`` samples with the int8 convolutions; the classifier's
    embeddings of the sampled signal are those of the classifier run outside any
    int8 scope, and no classifier convolution reaches ``quant_conv``."""
    bundle = common.build_inference(dtype=torch.float32, num_steps=2, solver="dpmpp_2m",
                                    gl_iters=1, device="cpu", tiny=True, int8=True)
    clf = randomize_(Classifier(TINY_CLF, 6), 2).eval()
    seen = []
    real = layers.quant_conv

    def spy(x, weight, *a):
        seen.append(weight.data_ptr())
        return real(x, weight, *a)

    batch = {"cond": np.zeros((2, 5), np.float32),
             "signal": np.random.default_rng(0).standard_normal((2, 3, 128, 128)).astype(
                 np.float32)}
    layers.quant_conv = spy
    try:
        out = evaluate.evaluate_batch(bundle, clf, batch, torch.Generator().manual_seed(0))
    finally:
        layers.quant_conv = real
    clf_weights = {p.data_ptr() for p in clf.parameters()}
    unet_weights = {p.data_ptr() for p in bundle.unet.parameters()}
    assert seen and not clf_weights & set(seen) and unet_weights & set(seen)
    with torch.no_grad():
        for which, signal in (("predicted", out["predicted_signal"]),
                              ("target", torch.from_numpy(batch["signal"]))):
            emb, logits = clf.embed_and_logits(signal.movedim(1, -1))
            np.testing.assert_array_equal(emb, out[f"{which}_classifier_embedding"])
            np.testing.assert_array_equal(logits, out[f"{which}_classifier_pred"])
    assert all(torch.isfinite(out[f"{which}_classifier_embedding"]).all()
               for which in ("predicted", "target"))

    # the CLI: --int8 reaches the bundle (1d_edm, no classifier): other signals than f32's
    config = configs.MovingAverageEnvelopeConfig(workdir=str(tmp_path / "eval"))
    make_synthetic_dataset(config.datapath, n=4, t=config.t)
    unet, _ = common.build_unet(config, 6, 6, dims=1, model_channels=common.TINY_CHANNELS)
    torch.save(randomize_(unet, 0).state_dict(), tmp_path / "unet1d.pt")
    argv = ["--workdir", str(tmp_path / "eval"), "--config", "1d_edm", "--unet-weights",
            str(tmp_path / "unet1d.pt"), "--tiny", "--device", "cpu", "--dtype", "f32",
            "--split", "full", "-b", "2", "--num-steps", "2", "--no-classifier",
            "--limit-batches", "1"]
    preds = {}
    for flag in ([], ["--int8"]):
        evaluate.main([*argv, "--suffix", f"-{len(flag)}", *flag])
        path = tmp_path / "eval" / "evaluation" / f"EDM-MovingAvg-{len(flag)}-split_full-rank_0.h5"
        with h5py.File(path, "r") as f:
            preds[bool(flag)] = f["predicted_signal"][:]
    assert np.isfinite(preds[True]).all() and not np.array_equal(preds[True], preds[False])


def test_int8_scope_is_off_outside_and_nests():
    assert not int8_enabled()
    with int8_scope():
        assert int8_enabled()
        with int8_scope(False):
            assert os.environ.get("TQDNE_INT8_CONV") == "1" or not int8_enabled()
        assert int8_enabled()
    assert not int8_enabled()
