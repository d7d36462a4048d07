"""NN primitives: the port of ``tqdne_tpu/nn/layers.py``.

Inside the port, activations are (B, C, *spatial) tensors kept in
channels-last memory (``torch.channels_last`` for 2D), so the GroupNorm
kernel reads them as the (B, S, C) slab the JAX package works on and the
convolutions take cuDNN's NHWC path.  Module and parameter names follow the
flax scopes, so ``utils.convert`` maps a flax tree onto them one to one.

Compute dtype: a convolution or dense layer casts its input, weight and bias
to its ``compute_dtype`` on every call (flax's ``dtype=`` with
``param_dtype=float32``), so gradients land in float32 parameters;
``set_compute_dtype`` sets it on a whole model.  Left at None it follows the
weight's dtype, which is how a model whose weights were cast once for
inference runs.  ``Norm32`` returns its input's dtype with f32 statistics and
keeps its scale and bias in their own dtype.

``modulate`` and ``gated_add`` are the token-major (B, L, C) LayerNorm with
per-sample modulation and the gated residual of ``models.dit``, which the JAX
package has no counterpart of.

Two scopes change the layers' arithmetic, not their parameters:
``nn.quant.int8_scope`` runs every convolution as ``quant_conv`` (on its input
and weight as they come, as the JAX ``QuantConv`` does), and
``parallel.spatial.spatial_scope`` runs them on this rank's rows of each
activation: a convolution takes its halo rows from the neighbouring shards
and ``Norm32`` merges the statistics of every shard.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tqdne_tpu_torch.nn.quant import int8_enabled, quant_conv
from tqdne_tpu_torch.ops.conv_bias import conv_bias_add
from tqdne_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_sharded
from tqdne_tpu_torch.parallel import spatial
from tqdne_tpu_torch.utils.tracing import span


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
        with span("norm"):
            h = x.movedim(1, -1).contiguous()  # a view when x is channels-last
            scale, bias = self.weight, self.bias
            if h.dtype == torch.float32 and scale.dtype != torch.float32:
                # f32 activations over cast norms: the int8 mode's convolutions return their
                # input's dtype, as the JAX ones do
                scale, bias = scale.float(), bias.float()
            scope = spatial.current()
            if scope is not None and scope.sharded:
                h = group_norm_silu_sharded(h, scale, bias, self.groups, 1e-5, self.silu,
                                            scope.gather_stats)
            else:
                h = group_norm_silu(h, scale, bias, self.groups, 1e-5, self.silu)
            return h.movedim(-1, 1)


class _Cast:
    """Input, weight and bias in ``compute_dtype`` (None: the weight's)."""

    compute_dtype: torch.dtype | None = None

    def _cast(self, x):
        weight, bias = self.weight, self.bias
        dtype = self.compute_dtype or weight.dtype
        if weight.dtype != dtype:
            weight = weight.to(dtype)
            bias = None if bias is None else bias.to(dtype)
        return x.to(dtype), weight, bias


class _Conv(_Cast):
    """The forward of ``conv_nd``'s convolutions: cuDNN without its bias, then
    ``ops.conv_bias.conv_bias_add`` of the bias and an optional per-sample
    ``shift`` (B, C) in place, in one pass; under a sharded spatial scope with
    the halo rows of the neighbouring shards and no padding along the rows, and
    under the int8 scope as ``quant_conv`` (its own bias, then ``shift`` added)."""

    def forward(self, x, shift=None):
        with span("conv"):
            padding = self.padding
            scope = spatial.current()
            if scope is not None and scope.sharded and self.kernel_size[0] > 1:
                p, s = self.padding[0], self.stride[0]
                # rows 2i - p .. 2i + p of a stride-2 output need none below the shard
                x = spatial.halo_rows(x, p, max(0, p - s + 1), scope)
                padding = (0, *self.padding[1:])
            if int8_enabled():
                y = quant_conv(x, self.weight, self.bias, self.stride, padding)
                if shift is None:
                    return y
                return y + shift.to(y.dtype).view(*shift.shape, *(1,) * (y.dim() - 2))
            x, weight, bias = self._cast(x)
            conv = F.conv1d if isinstance(self, nn.Conv1d) else F.conv2d
            y = conv(x, weight, None, self.stride, padding, self.dilation, self.groups)
            with span("conv_bias"):
                return conv_bias_add(y, bias, None if shift is None else shift.to(y.dtype))


class _Conv1d(_Conv, nn.Conv1d):
    pass


class _Conv2d(_Conv, nn.Conv2d):
    pass


class Dense(_Cast, nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``Dense(dtype=)``)."""

    def forward(self, x):
        return F.linear(*self._cast(x))


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Run every convolution and dense layer of ``module`` in ``dtype`` with
    its parameters left as they are (None: in each weight's own dtype)."""
    for m in module.modules():
        if isinstance(m, _Cast):
            m.compute_dtype = dtype
    return module


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
        self.scale = scale  # W ~ N(0, scale^2)
        self.W = nn.Parameter(torch.randn(channels // 2) * scale, requires_grad=False)

    def forward(self, x):
        h = x[..., None].float() * self.W.float() * (2 * math.pi)
        return torch.cat([torch.sin(h), torch.cos(h)], dim=-1).to(x.dtype)


class Upsample(nn.Module):
    """Nearest-neighbour x2 upsampling, then a convolution when ``use_conv``."""

    def __init__(self, channels: int, use_conv: bool = True, dims: int = 2,
                 out_channels: int | None = None, kernel_size: int = 3):
        super().__init__()
        self.conv = conv_nd(dims, channels, out_channels or channels, kernel_size) \
            if use_conv else None

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """Stride-2 convolution, or without ``use_conv`` a 2-wide average pool
    with stride 2 (flax ``avg_pool``: VALID, an odd last row dropped)."""

    def __init__(self, channels: int, use_conv: bool = True, dims: int = 2,
                 out_channels: int | None = None, kernel_size: int = 3):
        super().__init__()
        if not use_conv and (out_channels or channels) != channels:
            raise ValueError(f"an average-pool Downsample keeps its {channels} channels, "
                             f"not {out_channels}")
        self.op = conv_nd(dims, channels, out_channels or channels, kernel_size, stride=2) \
            if use_conv else None
        self.pool = F.avg_pool1d if dims == 1 else F.avg_pool2d

    def forward(self, x):
        return self.pool(x, 2, 2) if self.op is None else self.op(x)


def modulate(x, shift, scale):
    """DiT's ``modulate(norm(x), shift, scale)``: LayerNorm over the channels of
    the tokens ``x`` (B, L, C) without affine, eps 1e-6 and f32 statistics,
    then the per-sample ``x (1 + scale) + shift`` with ``shift`` and ``scale``
    (B, C), in ``x``'s dtype."""
    with span("modulate"):
        h = F.layer_norm(x, x.shape[-1:], eps=1e-6)
        return torch.addcmul(shift[:, None], h, 1 + scale[:, None])


def gated_add(x, gate, y):
    """DiT's gated residual ``x + gate y`` with a per-sample ``gate`` (B, C)."""
    with span("modulate"):
        return torch.addcmul(x, gate[:, None], y)


class MLP(nn.Module):
    """Dense -> SiLU -> Dense."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, out)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))
