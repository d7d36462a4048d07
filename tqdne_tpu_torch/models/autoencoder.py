"""KL autoencoder: the port of ``tqdne_tpu/models/autoencoder.py``.

The conv down/up stacks with the flax module's parameter names; public
methods take and return the JAX layout (B, *spatial, C): ``moments``
(encoder output split into mean and log std), ``encode`` (the
reparameterised latent), ``encode_mean`` and ``decode``, plus
``kl_divergence``.  Training the autoencoder itself comes with its recipe.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tqdne_tpu_torch.nn.attention import AttentionBlock
from tqdne_tpu_torch.nn.layers import Downsample, Norm32, Upsample, conv_nd


class PlainResBlock(nn.Module):
    """Residual block without conditioning."""

    def __init__(self, channels: int, dropout: float = 0.0, out_channels: int | None = None,
                 kernel_size: int = 3, dims: int = 2):
        super().__init__()
        out_ch = out_channels or channels
        self.in_norm = Norm32(channels, silu=True)
        self.in_conv = conv_nd(dims, channels, out_ch, kernel_size)
        self.out_norm = Norm32(out_ch, silu=True)
        self.dropout = nn.Dropout(dropout)
        self.out_conv = conv_nd(dims, out_ch, out_ch, kernel_size)
        self.skip = None if out_ch == channels else conv_nd(dims, channels, out_ch, 1)

    def forward(self, x):
        h = self.in_conv(self.in_norm(x))
        h = self.out_conv(self.dropout(self.out_norm(h)))
        skip = x if self.skip is None else self.skip(x)
        return skip + h


class _ConvStack(nn.Module):
    """Shared body of Encoder and Decoder: named blocks run in order."""

    def _add(self, name: str, module: nn.Module):
        self.add_module(name, module)
        self.order.append(name)

    def forward(self, x):  # (B, C, *spatial) -> (B, C_out, *spatial')
        h = self.in_conv(x)
        for name in self.order:
            h = getattr(self, name)(h)
        return self.out_conv(h)


class Encoder(_ConvStack):
    """Conv downstack."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_kernel_size: int = 3, dims: int = 2, num_heads: int = 1):
        super().__init__()
        self.order = []
        k = conv_kernel_size
        ch = int(channel_mult[0] * model_channels)
        self.in_conv = conv_nd(dims, in_channels, ch, k)
        ds, block = 1, 0
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out_ch = int(mult * model_channels)
                self._add(f"down_{block}_res", PlainResBlock(ch, dropout, out_ch, k, dims))
                ch = out_ch
                if ds in attention_resolutions:
                    self._add(f"down_{block}_attn", AttentionBlock(ch, num_heads, dims))
                block += 1
            if level != len(channel_mult) - 1:
                self._add(f"down_{block}_downsample", Downsample(ch, dims, ch))
                ds *= 2
                block += 1
        self.out_conv = conv_nd(dims, ch, out_channels, k)


class Decoder(_ConvStack):
    """Conv upstack."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_kernel_size: int = 3, dims: int = 2, num_heads: int = 1):
        super().__init__()
        self.order = []
        k = conv_kernel_size
        ch = int(channel_mult[-1] * model_channels)
        self.in_conv = conv_nd(dims, in_channels, ch, k)
        ds, block = 2 ** (len(channel_mult) - 1), 0
        for level, mult in reversed(list(enumerate(channel_mult))):
            if level != len(channel_mult) - 1:
                self._add(f"up_{block}_upsample", Upsample(ch, dims, ch))
                ds //= 2
                block += 1
            for _ in range(num_res_blocks):
                out_ch = int(mult * model_channels)
                self._add(f"up_{block}_res", PlainResBlock(ch, dropout, out_ch, k, dims))
                ch = out_ch
                if ds in attention_resolutions:
                    self._add(f"up_{block}_attn", AttentionBlock(ch, num_heads, dims))
                block += 1
        self.out_conv = conv_nd(dims, ch, out_channels, k)


class AutoencoderKL(nn.Module):
    """VAE with ``encoder`` and ``decoder`` submodules (flax scope names)."""

    def __init__(self, encoder_config: dict, decoder_config: dict):
        super().__init__()
        self.encoder = Encoder(**encoder_config)
        self.decoder = Decoder(**decoder_config)

    def moments(self, x):
        """(B, *spatial, C) -> (mean, log_std), each (B, *latent, C_latent)."""
        out = self.encoder(x.movedim(-1, 1)).movedim(1, -1)
        mean, log_std = out.chunk(2, dim=-1)
        return mean, log_std

    def encode(self, x, *, eps=None, generator: torch.Generator | None = None):
        """Stochastic latent mean + eps * exp(log_std), in the compute dtype.
        ``eps`` (the standard-normal draw, latent-shaped) is injected, or
        drawn from ``generator`` (the device's default one when None)."""
        mean, log_std = self.moments(x)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                              dtype=mean.dtype)
        return mean + eps.to(mean.dtype) * torch.exp(log_std)

    def encode_mean(self, x):
        """Deterministic latent: the posterior mean."""
        return self.moments(x)[0]

    def decode(self, z):
        """(B, *latent, C_latent) -> (B, *spatial, C), in the compute dtype."""
        return self.decoder(z.movedim(-1, 1)).movedim(1, -1)


def kl_divergence(mean, log_std):
    """KL(q || N(0, I)) summed over the channel (last) axis; returns
    ``mean.shape[:-1]``."""
    log_var = 2.0 * log_std
    return 0.5 * torch.sum(mean**2 + torch.exp(log_var) - log_var - 1.0, dim=-1)
