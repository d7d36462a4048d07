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
from tqdne_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from tqdne_tpu.ops.group_norm import group_norm_silu as jax_group_norm_silu
from tqdne_tpu_torch.ops import cuda_build, spectral
from tqdne_tpu_torch.ops.flash_attention import (
    _check,
    attention_delta,
    flash_attention,
    flash_attention_plain,
    flash_attention_bwd_dkdv,
    flash_attention_bwd_dq,
    tensor_core_plan,
)
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


@pytest.mark.parametrize("l,h,d,causal", [
    (16, 4, 128, False),  # the flagship UNet's attention: JAX pads the keys to 128
    (16, 4, 128, True),
    (100, 2, 64, False),  # ragged
    (130, 2, 32, False),  # two JAX key blocks, padded queries
    (130, 2, 32, True),
])
def test_flash_attention_gradients_match_jax_kernels(rng, l, h, d, causal):
    """dq, dk, dv through the port's autograd Function (its plain backward on
    the CPU) against jax.grad through the Pallas backward kernels
    (_bwd_dkdv_kernel, _bwd_dq_kernel) in interpret mode.  A non-uniform
    cotangent; rtol 2e-3 / atol 2e-4, the JAX package's own gradient bound."""
    q, k, v, g = (rng.standard_normal((2, l, h, d)).astype(np.float32) for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, 128, 128, True) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # q, k and v as strided views of one fused projection, as the attention block gives them
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).requires_grad_()
    (flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal) * _t(g)).sum().backward()
    for i, w in enumerate(want):
        np.testing.assert_allclose(qkv.grad[:, :, i].numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4)


def test_flash_backward_wrappers_match_autograd_of_the_einsum(rng):
    """The two backward wrappers, called directly with the forward's output
    and lse (dQ first, which also returns delta = rowsum(dO * O)), equal
    autograd through the plain einsum forward."""
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 20, 2, 16)).astype(np.float32))
                  for _ in range(4))
    out, lse = flash_attention(q, k, v, True, return_lse=True)
    dq, delta = flash_attention_bwd_dq(q, k, v, g, out, lse, True)
    torch.testing.assert_close(delta, attention_delta(g, out), rtol=0, atol=0)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, g, lse, delta, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, True), leaves, g)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=RTOL, atol=ATOL)


def test_wrappers_refuse_devices_without_a_kernel():
    """Neither wrapper falls back to its plain version off the CPU."""
    x = torch.empty(2, 16, 32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        group_norm_silu(x, torch.ones(32, device="meta"), torch.zeros(32, device="meta"))
    q = torch.empty(1, 16, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_attention(q, q, q)
    rows = torch.empty(1, 2, 16, device="meta")
    for backward in (flash_attention_bwd_dkdv, flash_attention_bwd_dq):
        with pytest.raises(RuntimeError, match="no kernel"):
            backward(q, q, q, q, rows, rows)


def _bf16_pairs(x):
    """x as bf16 hi + lo, the split the tensor-core kernels give P and dS."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def test_one_bf16_probability_breaks_the_tolerance():
    """Why the bf16 kernels split P (and dS) into two bf16 operands: the
    forward of the UNet's attention computed with P rounded to one bf16 misses
    the bf16 tolerance (rtol 1.6e-2, atol 1e-3) near zero, and hi + lo holds
    it.  Plain PyTorch emulates the kernel's products, which are exact for
    bf16 operands; bf16 inputs from a seed."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(32, 16, 4, 128, generator=gen).bfloat16() for _ in range(3))
    want = flash_attention_plain(q, k, v)
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * 128**-0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1).transpose(1, 2)[..., None]
    hi, lo = _bf16_pairs(p)

    def share(pp):
        out = (torch.einsum("bhls,bshd->blhd", pp, v.float()) / denom).bfloat16().float()
        return ((out - want.float()).abs() / (1e-3 + 1.6e-2 * want.float().abs())).max().item()

    assert share(hi) > 1.0 > share(hi + lo)


@pytest.mark.parametrize("d,head_block", [(8, 32), (16, 32), (32, 32), (40, 64), (64, 64),
                                          (100, 128), (128, 128)])
def test_tensor_core_plan_head_block(d, head_block):
    """The bf16 kernels take every D <= 128 in a head block of 32, 64 or 128
    (zero-padded to it in shared memory); D > 128 is refused first."""
    q = torch.zeros(2, 16, 4, d, dtype=torch.bfloat16)
    assert tensor_core_plan(q, q, q)[0] == head_block
    with pytest.raises(ValueError, match="unsupported shape"):
        _check("flash_attention", *(torch.zeros(2, 16, 4, 136, dtype=torch.bfloat16),) * 3)


@pytest.mark.parametrize("length,warps", [(1, 1), (16, 1), (17, 4), (256, 4), (508, 4)])
def test_tensor_core_plan_variant_follows_the_length(length, warps):
    """Four heads a block up to 16 tokens (the UNet's), four warps on one head beyond."""
    q = torch.zeros(1, length, 2, 64, dtype=torch.bfloat16)
    assert tensor_core_plan(q, q, q)[1] == warps


def test_tensor_core_plan_loads_16_bytes_only_where_aligned():
    """16-byte cp.async needs every row start 16-byte aligned: the fused qkv
    views of the models are; a D of 12, a view one element in, or a token
    stride off by one element take the 2-byte loads instead of failing."""
    qkv = torch.zeros(2, 16, 3, 4, 64, dtype=torch.bfloat16)
    views = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    assert tensor_core_plan(*views) == (64, 1, 1)
    _check("flash_attention", *views)  # strided views are taken as they are
    odd_d = torch.zeros(2, 16, 4, 12, dtype=torch.bfloat16)
    assert tensor_core_plan(odd_d, odd_d, odd_d)[2] == 0
    flat = torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 16, 4, 64)
    assert tensor_core_plan(views[0], shifted, views[2])[2] == 0
    padded = torch.zeros(2, 16, 4 * 64 + 1, dtype=torch.bfloat16)[..., :256].unflatten(-1, (4, 64))
    assert padded.stride(1) == 257 and tensor_core_plan(padded, padded, padded)[2] == 0
    with pytest.raises(ValueError, match="unit stride"):
        _check("flash_attention", *(torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)[..., ::2],) * 3)


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library is rebuilt when a header its source includes changes, not
    only when the source does."""
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = cuda_build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert cuda_build.library_path("k") not in (first, second)


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
    files = sorted((ROOT / "tqdne_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                ROOT / "chip_ab.py"]
    assert len(files) > 10
    banned = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "tqdne_tpu"):
                banned.append(f"{path.relative_to(ROOT)}: {name}")
    assert not banned, banned
