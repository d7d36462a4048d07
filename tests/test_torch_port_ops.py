"""The port's ops (tqdne_tpu_torch.ops) against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
plain versions its wrappers take for CPU tensors.  Inputs come from numpy
with a seed.  f32 tolerance: rtol 1e-4 / atol 1e-5 unless a test says why.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tqdne_tpu.ops import spectral as jspectral
from tqdne_tpu.ops.flash_attention import _flash_forward
from tqdne_tpu.ops.group_norm import group_norm_silu as jax_group_norm_silu
from tqdne_tpu_torch.ops import spectral
from tqdne_tpu_torch.ops.flash_attention import flash_attention
from tqdne_tpu_torch.ops.group_norm import group_norm_silu

RTOL, ATOL = 1e-4, 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 64, 64), 32, True), ((2, 8, 8, 128), 32, True), ((1, 100, 48), 16, True),
    ((2, 32, 64), 32, False), ((2, 16, 8), 8, False),
])
def test_group_norm_silu_matches_jax_kernel(rng, shape, groups, silu):
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jax_group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups,
                               1e-5, silu, True)
    got = group_norm_silu(_t(x), _t(scale), _t(bias), groups, 1e-5, silu)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_group_norm_silu_bf16_keeps_dtype(rng):
    """bf16 in, f32 statistics, bf16 out.  The JAX kernel's one-pass variance
    and the port's two-pass one may round a value to neighbouring bf16
    numbers, so the bound is one bf16 step (2^-7 relative)."""
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jax_group_norm_silu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                                          jnp.zeros(64), 32, 1e-5, True, True), np.float32)
    got = group_norm_silu(_t(x).bfloat16(), _t(scale), torch.zeros(64), 32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=2**-7)


def test_group_norm_silu_gradients_match_jax(rng):
    """The backward recomputes through the plain version, as the JAX _bwd
    does; gradients sum over the group, hence rtol 1e-3 as in the JAX
    package's own gradient test."""
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)

    def loss(x, s, b):
        return jnp.sum(jax_group_norm_silu(x, s, b, 32, 1e-5, True, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xs, ss, bs = (_t(a).requires_grad_() for a in (x, scale, bias))
    (group_norm_silu(xs, ss, bs, 32) ** 2).sum().backward()
    for g, w in zip((xs.grad, ss.grad, bs.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("l,h,d,causal", [
    (16, 4, 128, False),  # the flagship UNet's attention
    (16, 4, 128, True),
    (100, 2, 64, False),  # ragged: the JAX kernel pads to its block, the port masks
    (100, 2, 64, True),
    (130, 2, 32, False),  # two JAX key blocks
])
def test_flash_attention_matches_jax_kernel(rng, l, h, d, causal):
    q, k, v = (rng.standard_normal((2, l, h, d)).astype(np.float32) for _ in range(3))
    want, _, lse_p = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                    block_q=128, block_k=128, interpret=True, return_lse=True)
    want_lse = np.asarray(lse_p)[:, :l, 0].reshape(2, h, l)
    got, lse = flash_attention(_t(q), _t(k), _t(v), causal, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=RTOL, atol=ATOL)
    assert torch.equal(flash_attention(_t(q), _t(k), _t(v), causal), got)


def test_wrappers_refuse_devices_without_a_kernel():
    """Neither wrapper falls back to its plain version off the CPU."""
    x = torch.empty(2, 16, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        group_norm_silu(x, torch.ones(32, device="meta"), torch.zeros(32, device="meta"))
    q = torch.empty(1, 16, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_attention(q, q, q)


def test_stft_istft_match_jax(rng):
    x = rng.standard_normal((2, 3, 4064)).astype(np.float32)
    want = np.asarray(jspectral.stft(jnp.asarray(x), 256, 32, impl="fft"))
    got = spectral.stft(_t(x), 256, 32)
    assert got.shape == want.shape == (2, 3, 129, 128)
    # |X| reaches ~1e2 here: absolute error scales with the spectrum
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)
    back = spectral.istft(got, 256, 32, 4064)
    want_back = np.asarray(jspectral.istft(jnp.asarray(want), 256, 32, 4064, impl="fft"))
    np.testing.assert_allclose(back.numpy(), want_back, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(back.numpy(), x, rtol=RTOL, atol=ATOL)


def test_griffin_lim_matches_jax_with_injected_phase(rng):
    """Same magnitudes and the same initial phase (2 pi U drawn as the JAX
    function draws it) give the same waveform.  Each iteration's FFT
    rounding compounds, so after 8 iterations the bound is 1e-4 of the
    waveform's peak."""
    mag = np.abs(rng.standard_normal((2, 129, 64))).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jspectral.griffin_lim(jnp.asarray(mag), key, 256, 32, 2016, n_iter=8,
                                            impl="fft"))
    phase = 2.0 * math.pi * np.asarray(jax.random.uniform(key, mag.shape, dtype=jnp.float32))
    got = spectral.griffin_lim(_t(mag), 256, 32, 2016, n_iter=8, init_phase=_t(phase))
    assert got.shape == want.shape == (2, 2016)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "tqdne_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    banned = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "tqdne_tpu"):
                banned.append(f"{path.relative_to(ROOT)}: {name}")
    assert not banned, banned
