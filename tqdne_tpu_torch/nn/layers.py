"""NN primitives: the port of ``tqdne_tpu/nn/layers.py``.

Inside the port, activations are (B, C, *spatial) tensors kept in
channels-last memory (``torch.channels_last`` for 2D), so the GroupNorm
kernel reads them as the (B, S, C) slab the JAX package works on and the
convolutions take cuDNN's NHWC path.  Module and parameter names follow the
flax scopes, so ``utils.convert`` maps a flax tree onto them one to one.

Compute dtype follows the weights: a convolution or dense layer casts its
input to its weight's dtype (flax's ``dtype=`` promotion), and ``Norm32``
returns its input's dtype with f32 statistics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tqdne_tpu_torch.ops.group_norm import group_norm_silu


class Norm32(nn.Module):
    """GroupNorm(gcd(32, C)) in float32 with eps 1e-5, cast back to the input
    dtype, with an optional SiLU.  Always the fused ``group_norm_silu``:
    the kernel on CUDA, its plain version on the CPU."""

    def __init__(self, channels: int, silu: bool = False, groups: int = 32):
        super().__init__()
        self.groups = math.gcd(groups, channels)
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):  # (B, C, *spatial)
        h = x.movedim(1, -1).contiguous()  # a view when x is channels-last
        h = group_norm_silu(h, self.weight, self.bias, self.groups, 1e-5, self.silu)
        return h.movedim(-1, 1)


class _Conv1d(nn.Conv1d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class _Conv2d(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Dense(nn.Linear):
    """``nn.Linear`` computing in its weight's dtype (flax ``Dense(dtype=)``)."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


def conv_nd(dims: int, in_channels: int, out_channels: int, kernel_size: int, *,
            stride: int = 1) -> nn.Module:
    """1D/2D convolution with symmetric k//2 padding: flax "SAME" at stride 1
    and the explicit (k//2, k//2) padding the JAX package uses at stride 2."""
    if kernel_size % 2 == 0:
        raise ValueError(f"odd kernel sizes only, got {kernel_size}")
    cls = {1: _Conv1d, 2: _Conv2d}.get(dims)
    if cls is None:
        raise ValueError(f"unsupported dims: {dims}")
    return cls(in_channels, out_channels, kernel_size, stride=stride, padding=kernel_size // 2)


class GaussianFourierProjection(nn.Module):
    """[sin(2 pi x W), cos(2 pi x W)] with frozen W; output in x's dtype."""

    def __init__(self, channels: int, scale: float = 0.02):
        super().__init__()
        self.W = nn.Parameter(torch.randn(channels // 2) * scale, requires_grad=False)

    def forward(self, x):
        h = x[..., None].float() * self.W.float() * (2 * math.pi)
        return torch.cat([torch.sin(h), torch.cos(h)], dim=-1).to(x.dtype)


class Upsample(nn.Module):
    """Nearest-neighbour x2 upsampling then a convolution."""

    def __init__(self, channels: int, dims: int = 2, out_channels: int | None = None,
                 kernel_size: int = 3):
        super().__init__()
        self.conv = conv_nd(dims, channels, out_channels or channels, kernel_size)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 convolution."""

    def __init__(self, channels: int, dims: int = 2, out_channels: int | None = None,
                 kernel_size: int = 3):
        super().__init__()
        self.op = conv_nd(dims, channels, out_channels or channels, kernel_size, stride=2)

    def forward(self, x):
        return self.op(x)


class MLP(nn.Module):
    """Dense -> SiLU -> Dense."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, out)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))
