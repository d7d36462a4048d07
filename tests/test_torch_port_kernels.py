"""Launch plans and the arithmetic of the port's redesigned kernels, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  Here: the GroupNorm kernel's launch plan for
every shape the flagship paths give it, a PyTorch emulation of the chunked
statistics that plan implies against the JAX package's ``_reference``, and
the fused dQ + delta entry and the backward's new order against the JAX
``custom_vjp`` in interpret mode.  Inputs come from numpy with a seed.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tqdne_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from tqdne_tpu.ops.group_norm import _reference as jax_gn_reference
from tqdne_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_delta_plain,
    flash_attention_bwd_dq_plain,
)
from tqdne_tpu_torch.ops.group_norm import MAX_SMEM, group_norm_plan

F32, BF16 = torch.float32, torch.bfloat16
PAIRS = [(F32, F32), (BF16, BF16), (BF16, F32)]
# (S, C) of every GroupNorm call: the flagship UNet's (S = 32 x 32 down to 4 x 4), then the
# autoencoder's (S = 128 x 128 down to 32 x 32), decoder and encoder
UNET = [(1024, 128), (256, 128), (256, 256), (64, 256), (64, 512), (16, 512), (16, 1024),
        (64, 1024), (64, 768), (256, 768), (256, 512), (256, 384), (1024, 384), (1024, 256)]
AUTOENCODER = [(1024, 256), (4096, 256), (4096, 128), (16384, 128), (16384, 64), (4096, 64),
               (1024, 128)]
PATH_SHAPES = sorted(set(UNET + AUTOENCODER))


def _check_plan(p, b, s, c, g, x_dtype, aligned):
    esize = 4 if x_dtype == F32 else 2
    gsize = c // g
    cs = p.slice_channels
    assert cs % gsize == 0 and c % cs == 0 and p.slices * cs == c  # whole groups
    assert p.cluster * p.chunk_rows >= s > (p.cluster - 1) * p.chunk_rows  # chunks tile S
    assert 1 <= p.cluster <= 16
    assert p.smem <= MAX_SMEM
    if p.resident:
        assert p.smem >= p.chunk_rows * cs * esize  # the chunk is staged whole
    if p.vec > 1:  # 16-byte accesses only on aligned rows
        assert aligned and p.vec * esize == 16 and c % p.vec == 0 and cs % p.vec == 0
    else:
        assert not aligned or c * esize % 16
    assert p.rows_per_pass * cs // p.vec <= p.threads <= 1024 and p.threads % 32 == 0
    assert p.rows_per_pass <= p.chunk_rows


@pytest.mark.parametrize("b", [32, 128])
@pytest.mark.parametrize("s,c", PATH_SHAPES)
def test_group_norm_plan_on_the_paths(b, s, c):
    """Every (B, S, C, G, dtype pair) of sampling (B 32) and training (B 128):
    one resident chunk a block, 16-byte loads, enough blocks to cover 132
    SMs, and clusters within the card's limit (16 blocks on an H100, 8 where
    a card co-schedules no more)."""
    g = math.gcd(32, c)
    for x_dtype, p_dtype in PAIRS:
        for limit in (16, 8):
            p = group_norm_plan(b, s, c, g, x_dtype, p_dtype, True, limit)
            _check_plan(p, b, s, c, g, x_dtype, True)
            assert p.resident and p.vec > 1 and p.cluster <= limit
            assert b * p.slices * p.cluster >= 132


@pytest.mark.parametrize("b,s,c,g,x_dtype,aligned", [
    (2, 17, 40, 8, F32, True),     # gsize 5: a slice is lcm(5, 4) = 20 channels
    (2, 17, 40, 8, BF16, True),    # lcm(5, 8) = 40: the whole row
    (3, 17, 64, 32, BF16, False),  # an unaligned view: element loads
    (2, 100, 12, 4, BF16, True),   # C * 2 bytes is not a multiple of 16
    (1, 1, 32, 32, F32, True),     # one row
    (4, 16384, 1024, 1, F32, False),  # one group of 1024 channels, element loads
])
def test_group_norm_plan_odd_cases(b, s, c, g, x_dtype, aligned):
    for p_dtype in (F32, x_dtype):
        p = group_norm_plan(b, s, c, g, x_dtype, p_dtype, aligned)
        _check_plan(p, b, s, c, g, x_dtype, aligned)
    if not aligned or c * (4 if x_dtype == F32 else 2) % 16:
        assert p.vec == 1


def test_group_norm_plan_grows_the_cluster_then_reads_again():
    """A (sample, slice) too large for 8 resident chunks takes a larger
    cluster, up to what the card co-schedules; past that, chunks are read
    again from L2 instead of staged."""
    p = group_norm_plan(2, 32768, 64, 32, BF16, BF16, True)  # 2 MB a slice
    assert p.resident and 8 < p.cluster <= 16
    assert not group_norm_plan(2, 32768, 64, 32, BF16, BF16, True, max_cluster=8).resident
    big = group_norm_plan(2, 65536, 64, 32, F32, F32, True)  # 4 MB a slice
    assert not big.resident and big.cluster == 16
    _check_plan(big, 2, 65536, 64, 32, F32, True)
    for m in (1, 4, 8):
        assert group_norm_plan(2, 65536, 64, 32, F32, F32, True, max_cluster=m).cluster <= m
    with pytest.raises(TypeError, match="unsupported dtypes"):
        group_norm_plan(2, 16, 32, 32, F32, BF16, True)


def _chunked_group_norm(x, scale, bias, g, plan, eps=1e-5, silu=True, one_pass=False):
    """The kernel's arithmetic in f32 PyTorch, chunk by chunk as ``plan`` cuts
    (B, S, C): per chunk the group mean m1, then the sums of d = x - m1 and
    of d^2 (the corrected two-pass: mean m1 + sum(d) / n, M2 sum(d^2) -
    sum(d)^2 / n), merged in rank order with Chan's formula; then (x - mean)
    * (rstd * scale) + bias and SiLU.  ``one_pass`` takes the TPU kernel's
    E[x^2] - mean^2 over the whole group instead."""
    b, s, c = x.shape
    gsize = c // g
    xg = x.reshape(b, s, g, gsize)
    if one_pass:
        mean = xg.mean(dim=(1, 3))
        var = (xg * xg).mean(dim=(1, 3)) - mean * mean
    else:
        n = torch.zeros(b, g)
        mean = torch.zeros(b, g)
        m2 = torch.zeros(b, g)
        for rank in range(plan.cluster):
            chunk = xg[:, rank * plan.chunk_rows:(rank + 1) * plan.chunk_rows]
            nb = float(chunk.shape[1] * gsize)
            m1 = chunk.sum(dim=(1, 3)) * (1.0 / nb)
            d = chunk - m1[:, None, :, None]
            s1, s2 = d.sum(dim=(1, 3)), (d * d).sum(dim=(1, 3))
            total = n + nb
            delta = m1 + s1 / nb - mean
            frac = nb / total
            mean = mean + delta * frac
            m2 = m2 + (s2 - s1 * s1 / nb) + delta * delta * n * frac
            n = total
        var = m2 / n
    rstd = torch.rsqrt(var + eps)
    a = (rstd.repeat_interleave(gsize, dim=1) * scale)[:, None, :]
    y = (x - mean.repeat_interleave(gsize, dim=1)[:, None, :]) * a + bias
    return F.silu(y) if silu else y


@pytest.mark.parametrize("b,s,c,g", [(2, 4096, 64, 32), (2, 17, 40, 8), (3, 1024, 256, 32)])
def test_chunked_statistics_match_the_reference_far_from_zero(rng, b, s, c, g):
    """On data of mean 1e3 and spread 30 the planned chunking holds the JAX
    ``_reference`` and the float64 result to the f32 tolerance (rtol 1e-4,
    atol 1e-5); the TPU kernel's f32
    E[x^2] - mean^2 misses the tolerance there.  (At a smaller spread the
    f32 rounding of a mean near 1e3, about 3e-5, alone takes any f32 result
    past the tolerance, the reference's included.)"""
    x = (30 * rng.standard_normal((b, s, c)) + 1e3).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    want = np.asarray(jax_gn_reference(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), g,
                                       1e-5, True))
    plan = group_norm_plan(b, s, c, g, F32, F32, True)
    args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), g, plan)
    got = _chunked_group_norm(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    x64 = x.astype(np.float64).reshape(b, s, g, c // g)
    mean = x64.mean(axis=(1, 3), keepdims=True)
    y = ((x64 - mean) / np.sqrt(((x64 - mean) ** 2).mean(axis=(1, 3), keepdims=True) + 1e-5))
    y = y.reshape(b, s, c) * scale + bias
    exact = y / (1 + np.exp(-y))
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5)
    one_pass = _chunked_group_norm(*args, one_pass=True).numpy()
    assert not np.allclose(one_pass, want, rtol=1e-4, atol=1e-5)


def test_fused_dq_delta_entry_matches_its_parts(rng):
    """``flash_attention_bwd_dq`` (on the CPU, its plain version) returns the
    dQ of ``flash_attention_bwd_dq_plain`` with the delta of
    ``attention_delta``, bf16 included."""
    for dtype, causal in ((torch.float32, False), (torch.bfloat16, True)):
        q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 17, 2, 32)).astype(np.float32))
                      .to(dtype) for _ in range(4))
        out, lse = flash_attention(q, k, v, causal, return_lse=True)
        delta = attention_delta(g, out)
        want = flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, causal)
        for dq, got_delta in (flash_attention_bwd_dq(q, k, v, g, out, lse, causal),
                              flash_attention_bwd_dq_delta_plain(q, k, v, g, out, lse, causal)):
            assert dq.dtype == dtype and got_delta.dtype == torch.float32
            assert got_delta.shape == lse.shape and got_delta.is_contiguous()
            torch.testing.assert_close(dq, want, rtol=0, atol=0)
            torch.testing.assert_close(got_delta, delta, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", [16, 17, 100])
def test_backward_in_its_new_order_matches_jax(rng, length, causal):
    """dq, dk, dv through ``_FlashAttention`` (dQ and delta first, then dK/dV
    with that delta) against jax.grad through the Pallas backward kernels in
    interpret mode; rtol 2e-3 / atol 2e-4, the JAX package's gradient bound."""
    q, k, v, g = (rng.standard_normal((2, length, 2, 32)).astype(np.float32) for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal, 128, 128, True) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*leaves, causal) * torch.from_numpy(g)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=2e-3, atol=2e-4)
