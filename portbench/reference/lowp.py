"""Roundings for the lower-precision controls: a reference computed one
precision below what a configuration states, which the comparison that
decides ``correct`` has to fail."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def fp8(x):
    """Round to float8 e4m3 with a per-tensor scale on the absolute maximum;
    the gradient passes straight through."""
    if not x.is_floating_point():
        return x
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-12)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


def bf16(z):
    """Round to bfloat16 and back (the real and imaginary parts apart)."""
    if z.is_complex():
        return torch.complex(z.real.bfloat16().float(), z.imag.bfloat16().float())
    return z.bfloat16().float()
